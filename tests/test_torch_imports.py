"""Package rules of the PyTorch port: it imports neither JAX nor the JAX
package, asks for the card unless told otherwise, and its CLI serves on
the CPU when asked, with every flag of the reference's CLI, and makes
the reference's argument errors."""
import ast
import dataclasses
import json
import os
import pathlib
import subprocess
import sys

import numpy as np

import pytest

torch = pytest.importorskip("torch")

from repro_torch.launch import serve  # noqa: E402
from repro_torch.models import registry  # noqa: E402
from repro_torch.serving.engine import EngineConfig, make_engine  # noqa: E402

ROOT = pathlib.Path(__file__).resolve().parents[1]
PORT_FILES = sorted((ROOT / "src" / "repro_torch").rglob("*.py")) + \
    [ROOT / "chip_smoke.py"]


def _imported(path):
    tree = ast.parse(path.read_text(), filename=str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.module:
            yield node.module


@pytest.mark.parametrize("path", PORT_FILES,
                         ids=lambda p: str(p.relative_to(ROOT)))
def test_no_jax_and_no_reference_imports(path):
    for mod in _imported(path):
        top = mod.split(".")[0]
        assert top not in ("jax", "jaxlib", "repro"), \
            f"{path.name} imports {mod}"


def test_cuda_is_the_default_device():
    if torch.cuda.is_available():
        pytest.skip("this host has CUDA: the default device is usable")
    with pytest.raises(RuntimeError, match="CUDA"):
        make_engine(registry.get("yi-6b", reduced=True), EngineConfig())


def test_unported_families_name_their_slice():
    """Every family resolves to its module, as in the reference's
    registry: the recurrent hybrid and the encoder-decoder (and a
    windowed config) no longer raise; an unknown id raises naming the
    ids there are."""
    from repro_torch.models import encdec, rglru, rwkv6, transformer
    cfg = registry.get_config("yi-6b")
    for family, module in (("hybrid", rglru), ("audio", encdec),
                           ("ssm", rwkv6), ("moe", transformer),
                           ("vlm", transformer), ("dense", transformer)):
        entry = registry.from_config(dataclasses.replace(cfg, family=family))
        assert entry.module is module, family
    assert registry.from_config(
        dataclasses.replace(cfg, window=64)).module is transformer
    for arch in ("qwen3-30b-a3b", "qwen2-vl-7b"):
        entry = registry.from_config(registry.get_config(arch))
        assert entry.module.__name__ == "repro_torch.models.transformer"
    assert registry.get_config("qwen2-vl-7b").mrope
    assert registry.get("recurrentgemma-9b", reduced=True).module is rglru
    assert registry.get("whisper-small").module is encdec
    with pytest.raises(KeyError, match="yi-6b"):
        registry.get_config("not-a-model")


def test_cli_serves_on_cpu(capsys):
    m = serve.main(["--device", "cpu", "--n-requests", "2",
                    "--prompt-len", "6", "--max-new", "3", "--paged",
                    "--page-size", "4", "--prefill-chunk", "4", "--pallas",
                    "--rate", "1e9"])
    assert m["requests"] == 2 and m["decoded_tokens"] == 6
    assert "[serve] yi-6b on cpu" in capsys.readouterr().out


def test_cli_serves_rwkv6_on_cpu(capsys):
    m = serve.main(["--arch", "rwkv6-7b", "--device", "cpu",
                    "--n-requests", "2", "--prompt-len", "6", "--max-new",
                    "3", "--paged", "--page-size", "4", "--prefill-chunk",
                    "4", "--pallas", "--rate", "1e9"])
    assert m["requests"] == 2 and m["decoded_tokens"] == 6
    assert m["kv_peak_tokens"] == 0
    assert "[serve] rwkv6-7b on cpu" in capsys.readouterr().out


@pytest.mark.parametrize("argv", [
    # 8 shared + 4 unique tokens prefilled whole: the first page is
    # mapped, no compute is skipped
    ["--shared-prefix", "8"],
    # 8 shared + 4 unique tokens in chunks of 4: the compute skip
    ["--shared-prefix", "8", "--prefill-chunk", "4"],
    # two prompt groups (make_grouped_prefix_trace) under the fused tick
    ["--shared-prefix", "8", "--groups", "2", "--group-skew", "0.5",
     "--prefill-chunk", "4", "--fuse-steps", "8", "--max-new", "8",
     "--n-requests", "6"],
], ids=["whole_prompt", "chunked", "groups_fused"])
def test_cli_serves_prefix_sharing_on_cpu(argv, capsys):
    base = ["--device", "cpu", "--n-requests", "4", "--prompt-len", "12",
            "--max-new", "5", "--paged", "--page-size", "8",
            "--prefix-sharing", "--pallas", "--rate", "1e9"]
    m = serve.main(base + argv)
    assert m["requests"] == int(argv[argv.index("--n-requests") + 1]
                                if "--n-requests" in argv else 4)
    assert m["kv_dedup_ratio_peak"] > 1.0
    assert (m["prefill_skipped_tokens"] > 0) == ("--prefill-chunk" in argv)
    if "--fuse-steps" in argv:
        assert m["fused_ticks"] > 0
    assert "[serve] yi-6b on cpu" in capsys.readouterr().out


def test_cli_prefix_sharing_requires_paged(capsys):
    with pytest.raises(SystemExit) as exc:
        serve.main(["--device", "cpu", "--prefix-sharing",
                    "--shared-prefix", "8"])
    assert exc.value.code == 2
    assert "--prefix-sharing requires --paged" in capsys.readouterr().err


@pytest.mark.parametrize("argv", [
    ["--replicas", "2"],
    ["--replicas", "2", "--router-policy", "prefix_affinity", "--paged",
     "--prefix-sharing", "--shared-prefix", "8", "--groups", "2"],
    ["--replicas", "2", "--router-policy", "least_loaded", "--paged",
     "--prefill-chunk", "4"],
    ["--replicas", "2", "--paged", "--tiers", "1:1"],
    ["--replicas", "3", "--paged", "--tiers", "1:2", "--prefill-chunk",
     "4", "--fuse-steps", "4", "--prefix-sharing", "--shared-prefix", "8"],
    ["--trace-out", "TRACE"],
    ["--replicas", "2", "--paged", "--tiers", "1:1", "--trace-out",
     "TRACE"],
], ids=["replicas", "prefix_affinity", "least_loaded", "tiers",
        "tiers_fused_shared", "trace_out", "tiers_trace_out"])
def test_cli_serves_cluster_and_export_flags(argv, tmp_path, capsys):
    """The cluster, tier and trace flags serve on the CPU: the reference's
    router metric keys, every request decoded, the shipments of a tiered
    run, and the trace's two files beside the printed phase report."""
    from repro.obs.metrics import ROUTER_METRIC_CONTRACT
    trace = str(tmp_path / "serve.trace.json")
    argv = [trace if a == "TRACE" else a for a in argv]
    m = serve.main(["--device", "cpu", "--n-requests", "4", "--prompt-len",
                    "12", "--max-new", "4", "--page-size", "8", "--pallas",
                    "--rate", "1e9", *argv])
    out = capsys.readouterr().out
    assert m["requests"] == 4 and m["decoded_tokens"] == 16
    replicas = int(argv[argv.index("--replicas") + 1]) \
        if "--replicas" in argv else 1
    if replicas > 1:
        assert set(m) == set(ROUTER_METRIC_CONTRACT)
        assert m["replicas"] == replicas == len(m["per_replica"])
        assert f"[serve] yi-6b x{replicas}" in out
        assert out.count("[serve]   replica ") == replicas
    if "--tiers" in argv:
        assert m["tiers"] == argv[argv.index("--tiers") + 1]
        assert m["shipments"] == 4 and m["shipped_pages"] == 8
        assert m["ship_cost_s"] > 0.0
        assert m["per_replica"][0]["requests"] == 0
    if "--prefix-sharing" in argv and "--tiers" not in argv:
        assert m["dedup_ratio_agg"] > 1.0
    if "--trace-out" in argv:
        doc = json.loads(pathlib.Path(trace).read_text())
        assert any(e["ph"] == "X" for e in doc["traceEvents"])
        lines = pathlib.Path(trace + ".jsonl").read_text().splitlines()
        kinds = {json.loads(line)["kind"] for line in lines}
        assert {"arrival", "admit", "finish"} <= kinds
        assert ("ship" in kinds) == ("--tiers" in argv)
        assert ("dispatch" in kinds) == (replicas > 1)
        assert f"-> {trace} (+ {trace}.jsonl)" in out
        assert "[serve] phases: {'prefill_s'" in out


@pytest.mark.parametrize("argv", [
    ["--placement", "affinity"],
    ["--placement", "interleave", "--placement-regions", "2"],
    ["--placement", "free-first"],
    ["--codesign"],
    ["--codesign", "--codesign-rows", "16"],
    ["--codesign", "--reconfig-cost", "0.001"],
    # everything at once on the fused tick with shared prompt pages
    ["--placement", "affinity", "--codesign", "--prefix-sharing",
     "--shared-prefix", "8", "--prefill-chunk", "4", "--fuse-steps", "4"],
], ids=["affinity", "interleave_regions", "free_first", "codesign",
        "codesign_rows", "reconfig_cost", "all_fused"])
def test_cli_serves_placement_and_codesign_on_cpu(argv, capsys):
    m = serve.main(["--device", "cpu", "--n-requests", "3", "--prompt-len",
                    "12", "--max-new", "4", "--paged", "--page-size", "4",
                    "--pallas", "--rate", "1e9", *argv])
    assert m["requests"] == 3 and m["decoded_tokens"] == 12
    if "--placement" in argv:
        policy = argv[argv.index("--placement") + 1]
        assert m["placement_policy"] == policy
        assert m["kv_gather_cost_mean_s"] > 0.0
    else:
        assert m["placement_policy"] == "none"
    if "--codesign" in argv:
        assert m["modeled_time_s"] > 0.0
        assert m["modeled_tokens_per_s"] > 0.0
        if "--codesign-rows" in argv:
            # the fixed 16 x (4096 / 16) array never reconfigures
            assert m["codesign_substrate"] == "SA-16x256"
            assert m["reconfigurations"] == 0
        else:
            assert m["codesign_substrate"] == "SNAKE"
    else:
        assert m["codesign_substrate"] == "none"
    if "--fuse-steps" in argv:
        assert m["fused_ticks"] > 0
    assert "[serve] yi-6b on cpu" in capsys.readouterr().out


@pytest.mark.parametrize("argv", [
    [],
    ["--paged", "--pallas", "--prefill-chunk", "8"],
    ["--share", "--fuse-steps", "4", "--trace-out", "TRACE"],
    ["--share", "--replicas", "2", "--trace-out", "TRACE"],
], ids=["dense", "paged_chunked", "shared_fused_traced", "router_traced"])
def test_serve_decode_runs_on_cpu(argv, tmp_path, capsys):
    """The port of ``examples/serve_decode.py``: both families, or yi-6b
    behind the router, every request decoded; the trace files written."""
    from repro_torch.launch import serve_decode
    trace = str(tmp_path / "sd.trace.json")
    argv = [trace if a == "TRACE" else a for a in argv]
    out = serve_decode.main(["--device", "cpu", "--n-requests", "3",
                             "--rate", "1e9", *argv])
    text = capsys.readouterr().out
    if "--replicas" in argv:
        assert set(out) == {"yi-6b"} and out["yi-6b"]["replicas"] == 2
        assert "[serve_decode] yi-6b x2 (prefix_affinity)" in text
    else:
        assert set(out) == {"yi-6b", "rwkv6-7b"}
    for m in out.values():
        assert m["requests"] == 3 and m["decoded_tokens"] == 36
    if "--trace-out" in argv:
        assert pathlib.Path(trace).exists()
        assert pathlib.Path(trace + ".jsonl").exists()
        assert "[serve_decode] phases:" in text


@pytest.mark.parametrize("argv,error", [
    (["--replicas", "2", "--router-policy", "prefix_affinity", "--paged"],
     "--router-policy prefix_affinity requires --prefix-sharing"),
    (["--replicas", "2", "--tiers", "1:1"], "--tiers requires --paged"),
    (["--replicas", "2", "--paged", "--tiers", "1-1"],
     "--tiers must look like P:D"),
    (["--replicas", "3", "--paged", "--tiers", "1:1"],
     "--tiers 1:1 must sum to --replicas (3)"),
    (["--replicas", "2", "--paged", "--tiers", "0:2"],
     "--tiers needs at least one replica per tier"),
    (["--placement", "affinity"], "--placement requires --paged"),
    (["--codesign-rows", "16"], "--codesign-rows requires --codesign"),
    (["--reconfig-cost", "0.1"], "--reconfig-cost requires --codesign"),
    (["--codesign", "--reconfig-cost", "-1"],
     "--reconfig-cost must be >= 0"),
], ids=["affinity_sharing", "tiers_paged", "tiers_form", "tiers_sum",
        "tiers_empty", "placement_paged", "rows_codesign", "cost_codesign",
        "cost_negative"])
def test_cli_reproduces_reference_argument_errors(argv, error, capsys):
    with pytest.raises(SystemExit) as exc:
        serve.main(["--device", "cpu", *argv])
    assert exc.value.code == 2
    assert error in capsys.readouterr().err


def test_profile_step_runs_on_cpu(capsys):
    from repro_torch.launch import profile_step
    out = profile_step.main(["--device", "cpu", "--batch", "2",
                             "--context", "20", "--chunk", "8",
                             "--steps", "2"])
    assert len(out["decode_step_ms"]) == 2
    assert len(out["prefill_chunk_ms"]) == 3      # 20 tokens in chunks of 8
    assert out["card"] == "cpu" and out["device_launches_per_step"] == 0
    assert '"arch": "yi-6b"' in capsys.readouterr().out


def test_profile_step_runs_rwkv6_on_cpu(capsys):
    from repro_torch.launch import profile_step
    out = profile_step.main(["--arch", "rwkv6-7b", "--device", "cpu",
                             "--batch", "2", "--context", "20",
                             "--steps", "2"])
    assert len(out["decode_step_ms"]) == 2
    assert out["chunk"] is None and len(out["prefill_chunk_ms"]) == 1
    # the recurrent state (tm_x, cm_x, wkv) of 2 layers x 2 lanes in
    # float32, read and written once a step
    assert out["cache_bytes_per_step"] == 2 * (2 * 2 * 4) * (
        2 * 128 + 4 * 32 * 32)
    assert '"arch": "rwkv6-7b"' in capsys.readouterr().out


def _reference_flags():
    """Every option string of the reference's serve parser, read from its
    source (its parser is built inside ``main``)."""
    tree = ast.parse((ROOT / "src" / "repro" / "launch" / "serve.py")
                     .read_text())
    return sorted({a.value for node in ast.walk(tree)
                   if isinstance(node, ast.Call)
                   and getattr(node.func, "attr", "") == "add_argument"
                   for a in node.args if isinstance(a, ast.Constant)
                   and str(a.value).startswith("--")})


@pytest.mark.parametrize("flag", _reference_flags())
def test_cli_knows_every_reference_flag(flag):
    """Each flag of the reference's CLI is the port's."""
    action = serve.build_parser()._option_string_actions.get(flag)
    assert action is not None, f"{flag} is unknown to the port's parser"


def test_cli_names_the_slice_of_every_reference_arch(capsys):
    """Every reference id is the port's, with the reference's config
    (full and reduced, field by field) and the module of its family."""
    from repro.models import registry as jregistry
    ids = jregistry.ARCH_IDS + jregistry.EXTRA_ARCH_IDS
    choices = serve.build_parser()._option_string_actions["--arch"].choices
    assert set(ids) <= set(choices)
    for arch in ids:
        for reduced in (False, True):
            cfg = registry.get(arch, reduced=reduced).config
            want = jregistry.get(arch, reduced=reduced).config
            assert dataclasses.asdict(cfg) == {
                f.name: getattr(want, f.name)
                for f in dataclasses.fields(cfg)}, (arch, reduced)
        got = registry.get(arch).module.__name__.rsplit(".", 1)[1]
        assert got == jregistry.get(arch).module.__name__.rsplit(".", 1)[1]


@pytest.mark.parametrize("arch,argv", [
    # MoE: chunked prefill through extend_step, the fused tick
    ("qwen3-30b-a3b", ["--prefill-chunk", "4", "--fuse-steps", "4"]),
    # MoE with a shared expert, prefix sharing
    ("kimi-k2-1t-a32b", ["--prefix-sharing", "--shared-prefix", "8"]),
    ("qwen2-vl-7b", ["--prefill-chunk", "4"]),
    ("stablelm-3b", []),
    # the recurrent hybrid: no pages; --prefill-chunk is ignored (whole
    # prompts), as for rwkv6
    ("recurrentgemma-9b", ["--prefill-chunk", "4"]),
    # the encoder-decoder with prefix sharing: its self K/V pages shared
    ("whisper-small", ["--prefix-sharing", "--shared-prefix", "8"]),
])
def test_cli_serves_new_archs_on_cpu(arch, argv, capsys):
    m = serve.main(["--arch", arch, "--device", "cpu", "--n-requests", "3",
                    "--prompt-len", "12", "--max-new", "4", "--paged",
                    "--page-size", "8", "--pallas", "--rate", "1e9", *argv])
    assert m["requests"] == 3 and m["decoded_tokens"] == 12
    if "--fuse-steps" in argv:
        assert m["fused_ticks"] > 0
    if "--prefix-sharing" in argv:
        assert m["kv_dedup_ratio_peak"] > 1.0
    if arch == "recurrentgemma-9b":
        assert m["kv_peak_tokens"] == 0
    assert f"[serve] {arch} on cpu" in capsys.readouterr().out


def test_profile_step_splits_moe_on_cpu(capsys):
    from repro_torch.launch import profile_step
    out = profile_step.main(["--arch", "qwen3-30b-a3b", "--device", "cpu",
                             "--batch", "2", "--context", "20", "--chunk",
                             "8", "--steps", "2"])
    assert len(out["prefill_chunk_ms"]) == 3
    assert out["moe_layer"]["decode"]["tokens"] == 2
    assert out["moe_layer"]["prefill_chunk"]["tokens"] == 8
    assert set(out["device_ms_by_kind_per_step"]) == {"gemm", "attention",
                                                      "other"}
    assert '"arch": "qwen3-30b-a3b"' in capsys.readouterr().out


@pytest.mark.parametrize("arch", ["recurrentgemma-9b", "whisper-small"])
def test_profile_step_runs_hybrid_and_audio_on_cpu(arch, capsys):
    """Both prefill whole prompts (no chunk), decode per tick with no
    kernel of the port, and count the bytes a step moves: recurrentgemma's
    whole state read and written, whisper's self K/V and cross K/V."""
    from repro_torch.launch import profile_step
    out = profile_step.main(["--arch", arch, "--device", "cpu", "--batch",
                             "2", "--context", "20", "--steps", "2"])
    assert out["chunk"] is None and len(out["prefill_chunk_ms"]) == 1
    assert out["port_kernels_ms_per_step"] == {}
    assert out["weight_bytes_per_step"] > 0 and out["cache_bytes_per_step"] > 0
    assert out["moe_layer"] is None
    assert f'"arch": "{arch}"' in capsys.readouterr().out


# ---------------------------------------------------------------------------
# The training entry points
# ---------------------------------------------------------------------------
def test_train_defaults_to_the_card():
    from repro_torch.launch import train
    if torch.cuda.is_available():
        pytest.skip("this host has CUDA: the default device is usable")
    with pytest.raises(RuntimeError, match="CUDA"):
        train.train("yi-6b", steps=1, global_batch=2, seq=32, ckpt_dir=None)


def test_train_cli_trains_on_cpu(tmp_path, capsys):
    from repro_torch.launch import train
    out = train.main(["--device", "cpu", "--arch", "yi-6b", "--steps", "4",
                      "--global-batch", "2", "--seq", "32", "--ckpt-dir",
                      str(tmp_path)])
    assert out["steps"] == 4 and np.isfinite(out["final_loss"])
    assert "[train] done" in capsys.readouterr().out
    assert (tmp_path / "step_0000000004" / "manifest.json").exists()


@pytest.mark.parametrize("flag", ["--data", "--model"])
def test_train_cli_refuses_a_mesh(flag):
    """A mesh of two ranks in one process without a process group is
    refused, naming the launcher that starts one process per rank."""
    from repro_torch.launch import train
    with pytest.raises(RuntimeError, match="torch.distributed.run"):
        train.main(["--device", "cpu", flag, "2"])


def test_train_cli_trains_on_a_mesh_under_torchrun(tmp_path):
    """``python -m torch.distributed.run --nproc-per-node 2 -m
    repro_torch.launch.train --device cpu --data 2``: two gloo ranks
    train the data-parallel step; rank 0 prints and saves."""
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"),
               OMP_NUM_THREADS="1")
    run = subprocess.run(
        [sys.executable, "-m", "torch.distributed.run", "--standalone",
         "--nproc-per-node", "2", "-m", "repro_torch.launch.train",
         "--device", "cpu", "--data", "2", "--steps", "3",
         "--global-batch", "4", "--seq", "32", "--ckpt-dir",
         str(tmp_path)], cwd=ROOT, env=env, capture_output=True,
        text=True, timeout=300)
    assert run.returncode == 0, run.stdout[-2000:] + run.stderr[-4000:]
    assert run.stdout.count("[train] done") == 1
    assert (tmp_path / "step_0000000003" / "manifest.json").exists()


def test_quickstart_and_train_lm_run_on_cpu(tmp_path, capsys):
    from repro_torch.launch import quickstart, train_lm
    gen = quickstart.main(["--device", "cpu"])
    assert np.asarray(gen).shape == (2, 4)
    out = train_lm.main(["--device", "cpu", "--steps", "6", "--seq", "32",
                         "--ckpt-dir", str(tmp_path)])
    assert out["final_loss"] < out["first_loss"]
    text = capsys.readouterr().out
    assert "SNAKE speedup vs MAC tree" in text and "size=10m" in text
    # the custom size resolved through the registry only while it ran
    with pytest.raises(KeyError):
        registry.get("lm-10m")
