"""How far the reference's greedy decoding drifts between its sharded and
unsharded programs, in bfloat16 and in float32.

Runs the JAX reference on a host mesh of placeholder CPU devices: the
sharded prefill and serve steps of ``launch.steps.build_cell`` (mesh
(1, 2) by default, sequence-sharded attention) against the unsharded
``prefill`` / ``decode_step`` on the same weights and prompts, each
dtype from the same seed.  Prints one JSON line per dtype: the
relative L2 error of the prefill and first-step logits, and for each
lane the first decode step whose greedy token differs (null: none in
``--steps``).

    PYTHONPATH=src python examples/ref_bf16_shard_drift.py
    PYTHONPATH=src python examples/ref_bf16_shard_drift.py --layers 4 \\
        --d-model 256 --steps 32
"""
import argparse
import json
import os
import sys


def main(argv=None):
    ap = argparse.ArgumentParser(prog="ref_bf16_shard_drift")
    ap.add_argument("--arch", default="yi-6b")
    ap.add_argument("--model", type=int, default=2,
                    help="ranks on the mesh's model axis")
    ap.add_argument("--layers", type=int, default=8)
    ap.add_argument("--d-model", type=int, default=512)
    ap.add_argument("--heads", type=int, default=8)
    ap.add_argument("--kv-heads", type=int, default=4)
    ap.add_argument("--d-head", type=int, default=64)
    ap.add_argument("--d-ff", type=int, default=1024)
    ap.add_argument("--vocab", type=int, default=4096)
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--prompt", type=int, default=96)
    ap.add_argument("--seq", type=int, default=128)
    ap.add_argument("--steps", type=int, default=16)
    args = ap.parse_args(argv)
    os.environ["XLA_FLAGS"] = (os.environ.get("XLA_FLAGS", "") + " "
                               "--xla_force_host_platform_device_count="
                               f"{args.model}")
    os.environ.setdefault("JAX_PLATFORMS", "cpu")

    import jax
    import jax.numpy as jnp
    import numpy as np

    from repro.launch.mesh import make_mesh
    from repro.launch.steps import (assemble_shardings, build_cell,
                                    make_prefill_step)
    from repro.models import registry
    from repro.models.config import ShapeCell

    mesh = make_mesh((1, args.model), ("data", "model"))
    tp = args.model
    prompts = np.random.default_rng(7).integers(
        0, args.vocab, (args.batch, args.prompt)).astype(np.int32)

    def rel(a, b):
        a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
        return float(np.linalg.norm(a - b) / np.linalg.norm(b))

    for dtype in ("bfloat16", "float32"):
        entry = registry.get(
            args.arch, reduced=True, dtype=dtype, num_layers=args.layers,
            d_model=args.d_model, num_q_heads=args.heads,
            num_kv_heads=args.kv_heads, d_head=args.d_head,
            d_ff=args.d_ff, vocab=args.vocab, max_seq=args.seq)
        cfg, mod = entry.config, entry.module
        params = mod.init(jax.random.PRNGKey(0), cfg, tp)
        tokens = jnp.asarray(prompts)

        def greedy(params, prefill, step):
            logits, cache = prefill(params, tokens)
            first = [np.asarray(logits)]
            tok = jnp.argmax(logits[:, :cfg.vocab], -1).astype(jnp.int32)
            toks = [np.asarray(tok)]
            for i in range(args.steps):
                logits, cache = step(params, cache, tok)
                if i == 0:
                    first.append(np.asarray(logits))
                tok = jnp.argmax(logits[:, :cfg.vocab],
                                 -1).astype(jnp.int32)
                toks.append(np.asarray(tok))
            return first, np.stack(toks, 1)

        base_first, base = greedy(
            params, jax.jit(lambda p, t: mod.prefill(p, cfg, t, tp=tp,
                                             max_seq=args.seq)),
            jax.jit(lambda p, c, t: mod.decode_step(p, cfg, t, c, tp=tp)))
        shape = ShapeCell("d", args.seq, args.batch, "decode")
        serve, _ = build_cell(entry, mesh, shape, seq_sharded_attn=True)
        _, (p_sh, c_sh, _), _ = assemble_shardings(entry, mesh, "decode",
                                                   shape)
        prefill = jax.jit(make_prefill_step(entry, tp, mesh,
                                            max_seq=args.seq))
        sh_first, sharded = greedy(
            jax.device_put(params, p_sh), lambda p, t: (lambda lc: (lc[0], jax.device_put(lc[1], c_sh)))(
                prefill(p, {"tokens": t})), serve)
        differ = sharded != base
        first_diff = [int(np.argmax(row)) if row.any() else None
                      for row in differ]
        print(json.dumps({
            "arch": args.arch, "dtype": dtype, "mesh": [1, args.model],
            "layers": args.layers, "d_model": args.d_model,
            "batch": args.batch, "prompt": args.prompt,
            "steps": args.steps,
            "prefill_logits_rel_err": rel(sh_first[0], base_first[0]),
            "step1_logits_rel_err": rel(sh_first[1], base_first[1]),
            "first_differing_step_per_lane": first_diff,
            "tokens_equal": int((~differ).sum()),
            "tokens": int(differ.size)}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
