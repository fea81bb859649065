"""Decode-attention kernels of the PyTorch port.

On the CPU the port's plain versions (``repro_torch.kernels.ref``) are
held against the JAX package's Pallas kernels run in interpret mode, on
the same numpy inputs: GQA groups of 1 and 4, float32 and bf16, a
0-length lane, and garbage past every length.  The CUDA kernels run only
on the card (the ``cuda``-marked test here, and ``chip_smoke.py``).
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from repro.kernels.flash_decode import flash_decode, paged_flash_decode  # noqa: E402
from repro_torch.kernels import build, ops, ref  # noqa: E402
from repro_torch.kernels import flash_decode as fd  # noqa: E402

GARBAGE = 75.0


def _tol(dtype):
    # bf16: both sides round the f32 result to bf16, which may land one
    # ulp apart (test_kernels.py uses 2e-2); f32: the same softmax summed
    # in another order
    return (dict(rtol=2e-2, atol=2e-2) if dtype == "bfloat16"
            else dict(rtol=2e-5, atol=2e-5))


def _pair(a: np.ndarray, dtype: str):
    """The same values as a JAX array and a torch tensor of ``dtype``
    (both round float32 to bf16 to nearest even)."""
    return (jnp.asarray(a).astype(getattr(jnp, dtype)),
            torch.from_numpy(a).to(getattr(torch, dtype)))


def _paged_case(g, dtype, seed=0, b=3, hkv=2, d=32, page=4,
                lengths=(0, 7, 13)):
    """Pools with pages dealt in shuffled order, the tail of each
    slot's last page and the scratch page filled with garbage."""
    rng = np.random.default_rng(seed)
    nblk = 4
    need = [-(-n // page) for n in lengths]
    p = sum(need) + 2
    order = rng.permutation(p)
    q = rng.standard_normal((b, hkv * g, d)).astype(np.float32)
    kp = rng.standard_normal((p + 1, page, hkv, d)).astype(np.float32)
    vp = rng.standard_normal((p + 1, page, hkv, d)).astype(np.float32)
    tables = np.full((b, nblk), p, np.int32)
    i = 0
    for s, n in enumerate(lengths):
        for j in range(need[s]):
            tables[s, j] = order[i]
            i += 1
        if n % page:
            last = tables[s, need[s] - 1]
            kp[last, n % page:] = GARBAGE
            vp[last, n % page:] = GARBAGE
    kp[p] = vp[p] = GARBAGE
    return q, kp, vp, tables, np.asarray(lengths, np.int32)


@pytest.mark.parametrize("g", [1, 4])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_paged_ref_matches_pallas(g, dtype):
    q, kp, vp, tables, lengths = _paged_case(g, dtype)
    (qj, qt), (kj, kt), (vj, vt) = (_pair(a, dtype) for a in (q, kp, vp))
    want = paged_flash_decode(qj, kj, vj, jnp.asarray(tables),
                              jnp.asarray(lengths), interpret=True)
    got = ref.paged_flash_decode_ref(qt, kt, vt, torch.from_numpy(tables),
                                     torch.from_numpy(lengths))
    assert got.dtype == qt.dtype
    np.testing.assert_allclose(got.float().numpy(),
                               np.asarray(want, np.float32), **_tol(dtype))
    assert not got[0].any()          # the 0-length lane gives zeros


@pytest.mark.parametrize("g", [1, 4])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_dense_ref_matches_pallas(g, dtype):
    rng = np.random.default_rng(1)
    b, hkv, d, s = 3, 2, 32, 40
    lengths = np.asarray([0, 17, 40], np.int32)
    q = rng.standard_normal((b, hkv * g, d)).astype(np.float32)
    k = rng.standard_normal((b, s, hkv, d)).astype(np.float32)
    v = rng.standard_normal((b, s, hkv, d)).astype(np.float32)
    for i, n in enumerate(lengths):
        k[i, n:] = v[i, n:] = GARBAGE
    (qj, qt), (kj, kt), (vj, vt) = (_pair(a, dtype) for a in (q, k, v))
    want = flash_decode(qj, kj, vj, jnp.asarray(lengths), block_s=16,
                        interpret=True)
    got = ref.flash_decode_ref(qt, kt, vt, torch.from_numpy(lengths))
    np.testing.assert_allclose(got.float().numpy(),
                               np.asarray(want, np.float32), **_tol(dtype))
    assert not got[0].any()


def test_wrappers_take_the_plain_path_on_cpu():
    fd.reset_launches()
    q, kp, vp, tables, lengths = (torch.from_numpy(a) for a in
                                  _paged_case(4, "float32"))
    got = ops.attention_decode_paged(q, kp, vp, tables, lengths)
    torch.testing.assert_close(
        got, ref.paged_flash_decode_ref(q, kp, vp, tables, lengths),
        rtol=0, atol=0)
    k = kp[tables.long()].reshape(3, -1, *kp.shape[2:])
    v = vp[tables.long()].reshape(3, -1, *vp.shape[2:])
    torch.testing.assert_close(ops.attention_decode(q, k, v, lengths),
                               got, rtol=0, atol=0)
    assert fd.LAUNCHES == {"flash_decode": 0, "paged_flash_decode": 0}
    with pytest.raises(ValueError):
        ops.attention_decode(q.to("meta"), k, v, lengths)


def _bad_inputs():
    """Inputs the CUDA kernels refuse, each with a name."""
    q, kp, vp, tables, lengths = (torch.from_numpy(a) for a in
                                  _paged_case(4, "float32"))
    half = [t.half() for t in (q, kp, vp)]
    wide = torch.zeros(3, 8, 48), torch.zeros(9, 4, 2, 48)
    return {
        "float16": (*half, tables, lengths),
        "head_dim_48": (wide[0], wide[1], wide[1], tables, lengths),
        "group_16": (torch.zeros(3, 32, 32), kp, vp, tables, lengths),
        "strided_last_dim": (q, kp.transpose(1, 3).contiguous()
                             .transpose(1, 3), vp, tables, lengths),
        "lengths_int64": (q, kp, vp, tables, lengths.long()),
        "tables_int64": (q, kp, vp, tables.long(), lengths),
        # D=64 f32 loads 8-byte pairs: a q one float off is misaligned
        "misaligned_rows": (torch.zeros(3 * 8 * 64 + 1)[1:].view(3, 8, 64),
                            torch.zeros(9, 4, 2, 64),
                            torch.zeros(9, 4, 2, 64), tables, lengths),
    }


@pytest.mark.parametrize("case", sorted(_bad_inputs()))
def test_check_args_refuses(case):
    q, kp, vp, tables, lengths = _bad_inputs()[case]
    with pytest.raises(ValueError):
        fd.check_args(q, kp, vp, lengths, tables)


def test_check_args_accepts_engine_layouts():
    q, kp, vp, tables, lengths = (torch.from_numpy(a) for a in
                                  _paged_case(4, "float32"))
    fd.check_args(q, kp, vp, lengths, tables)
    pools = torch.zeros(2, *kp.shape)          # a layer view of (L, ...)
    fd.check_args(q, pools[1], pools[1], lengths, tables)


def test_cuda_wrappers_refuse_cpu_tensors():
    q, kp, vp, tables, lengths = (torch.from_numpy(a) for a in
                                  _paged_case(4, "float32"))
    with pytest.raises(ValueError, match="CUDA"):
        fd.paged_flash_decode(q, kp, vp, tables, lengths)
    assert fd.LAUNCHES["paged_flash_decode"] == 0


def test_library_is_keyed_on_source(tmp_path, monkeypatch):
    src = tmp_path / "k.cu"
    src.write_text("// one\n")
    monkeypatch.setattr(build, "SRC_DIR", tmp_path)
    monkeypatch.setattr(build, "BUILD_DIR", tmp_path / "out")
    first = build.library_path(src)
    assert first == build.library_path(src)
    src.write_text("// two\n")
    assert build.library_path(src) != first
    assert first.parent == tmp_path / "out"


def test_build_without_nvcc_raises(tmp_path, monkeypatch):
    (tmp_path / "k.cu").write_text("// kernel\n")
    monkeypatch.setattr(build, "SRC_DIR", tmp_path)
    monkeypatch.setattr(build, "BUILD_DIR", tmp_path / "out")
    monkeypatch.setattr(build, "nvcc_path", lambda: (_ for _ in ()).throw(
        RuntimeError("nvcc not found")))
    with pytest.raises(RuntimeError, match="nvcc"):
        build.build_all()


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("g", [1, 4, 8])
def test_cuda_kernels_match_plain(dtype, g):
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (the kernels have no CPU mode)")
    q, kp, vp, tables, lengths = (torch.from_numpy(a).cuda() for a in
                                  _paged_case(g, dtype, d=64))
    q, kp, vp = (t.to(getattr(torch, dtype)) for t in (q, kp, vp))
    got = fd.paged_flash_decode(q, kp, vp, tables, lengths)
    want = ref.paged_flash_decode_ref(q, kp, vp, tables, lengths)
    torch.testing.assert_close(got.float(), want.float(), **_tol(dtype))
    k = kp[tables.long()].reshape(3, -1, *kp.shape[2:]).contiguous()
    v = vp[tables.long()].reshape(3, -1, *vp.shape[2:]).contiguous()
    torch.testing.assert_close(fd.flash_decode(q, k, v, lengths).float(),
                               want.float(), **_tol(dtype))
