"""Package rules of the PyTorch port: it imports neither JAX nor the JAX
package, asks for the card unless told otherwise, and its CLI serves on
the CPU when asked and refuses flags whose features are not ported."""
import ast
import dataclasses
import pathlib

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
    with pytest.raises(NotImplementedError, match="not ported"):
        registry.get("recurrentgemma-9b", reduced=True)
    cfg = registry.get_config("yi-6b")
    with pytest.raises(NotImplementedError, match="item 9"):
        registry.from_config(dataclasses.replace(cfg, family="hybrid"))
    with pytest.raises(NotImplementedError, match="item 8"):
        registry.from_config(dataclasses.replace(cfg, family="moe"))


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


@pytest.mark.parametrize("flag", [["--placement", "affinity"],
                                  ["--codesign"], ["--replicas", "2"],
                                  ["--tiers", "1:1"],
                                  ["--trace-out", "t.json"]])
def test_cli_refuses_unported_flags(flag, capsys):
    with pytest.raises(SystemExit) as exc:
        serve.main(["--device", "cpu", *flag])
    assert exc.value.code == 2
    assert f"{flag[0]} is not ported yet" in capsys.readouterr().err


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


def _non_default(action):
    """Arguments that give ``action`` a value other than its default."""
    if action.nargs == 0:
        return []
    if action.choices:
        return [str(next(c for c in action.choices if c != action.default))]
    if action.type is int:
        return ["2"]
    if action.type is float:
        return ["0.5"]
    return ["x.json"]


@pytest.mark.parametrize("flag", _reference_flags())
def test_cli_knows_every_reference_flag(flag, capsys):
    """Each flag of the reference's CLI is the port's: ported, or refused
    with an error that names it."""
    ap = serve.build_parser()
    action = ap._option_string_actions.get(flag)
    assert action is not None, f"{flag} is unknown to the port's parser"
    if action.dest not in serve.UNPORTED:
        return
    with pytest.raises(SystemExit) as exc:
        serve.main(["--device", "cpu", flag, *_non_default(action)])
    assert exc.value.code == 2
    assert f"{flag} is not ported yet" in capsys.readouterr().err


def test_cli_names_the_slice_of_every_reference_arch(capsys):
    from repro.models import registry as jregistry
    ids = jregistry.ARCH_IDS + jregistry.EXTRA_ARCH_IDS
    choices = serve.build_parser()._option_string_actions["--arch"].choices
    assert set(ids) <= set(choices)
    for arch in ids:
        if arch in ("yi-6b", "rwkv6-7b"):
            registry.get(arch, reduced=True)
            continue
        with pytest.raises(SystemExit) as exc:
            serve.main(["--device", "cpu", "--arch", arch])
        assert exc.value.code == 2
        err = capsys.readouterr().err
        assert f"{arch!r} is not ported yet" in err
        if arch in jregistry.EXTRA_ARCH_IDS:
            assert "queue 1, item 3" in err
