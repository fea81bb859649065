"""Kernels of the PyTorch port: flash decode, WKV6 and the SNAKE decode
GEMM.

On the CPU the port's plain versions (``repro_torch.kernels.ref``) are
held against the JAX package's Pallas kernels run in interpret mode, on
the same numpy inputs: for attention GQA groups of 1 and 4, float32 and
bf16, a 0-length lane, and garbage past every length; for WKV6 and the
GEMM the shapes and tolerances of ``tests/test_kernels.py``.  The port's
Hopper GEMM mapping is held to the paper's rule.  The CUDA kernels run
only on the card (the ``cuda``-marked tests here, and ``chip_smoke.py``).
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from repro.kernels import ref as jref  # noqa: E402
from repro.kernels.flash_decode import flash_decode, paged_flash_decode  # noqa: E402
from repro.kernels.snake_gemm import snake_decode_gemm  # noqa: E402
from repro.kernels.wkv6 import wkv6 as pallas_wkv6  # noqa: E402
from repro_torch.kernels import build, ops, ref  # noqa: E402
from repro_torch.kernels import flash_decode as fd  # noqa: E402
from repro_torch.kernels import snake_gemm as sg  # noqa: E402
from repro_torch.kernels import wkv6 as wk  # noqa: E402

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


# ---------------------------------------------------------------------------
# WKV6
# ---------------------------------------------------------------------------
WKV_SHAPES = [(1, 16, 2, 32), (2, 33, 4, 64), (1, 8, 1, 128)]
WKV_TOL = dict(rtol=1e-4, atol=1e-4)     # tests/test_kernels.py's


def _wkv_inputs(b, t, h, hs, seed=0):
    """r/k/v ~ N(0,1), decay w in (0.4, 0.9), bonus u and state0 small:
    the distributions of tests/test_kernels.py, drawn with numpy."""
    rng = np.random.default_rng(seed)
    r, k, v = rng.standard_normal((3, b, t, h, hs)).astype(np.float32)
    w = (0.5 / (1 + np.exp(-rng.standard_normal((b, t, h, hs))))
         + 0.4).astype(np.float32)
    u = (rng.standard_normal((h, hs)) * 0.1).astype(np.float32)
    s0 = (rng.standard_normal((b, h, hs, hs)) * 0.1).astype(np.float32)
    return r, k, v, w, u, s0


@pytest.mark.parametrize("b,t,h,hs", WKV_SHAPES)
def test_wkv6_ref_matches_pallas(b, t, h, hs):
    arrs = _wkv_inputs(b, t, h, hs, seed=t * h)
    y, s_t = ref.wkv6_ref(*(torch.from_numpy(a) for a in arrs))
    assert y.dtype == torch.float32 and s_t.shape == (b, h, hs, hs)
    for yw, sw in (pallas_wkv6(*(jnp.asarray(a) for a in arrs),
                               interpret=True),
                   jref.wkv6_ref(*(jnp.asarray(a) for a in arrs))):
        np.testing.assert_allclose(y.numpy(), np.asarray(yw), **WKV_TOL)
        np.testing.assert_allclose(s_t.numpy(), np.asarray(sw), **WKV_TOL)


def _wkv_composes(fn, device="cpu"):
    """wkv(T1 + T2) == wkv(T2) . wkv(T1), as tests/test_kernels.py holds
    the Pallas kernel (chunked serving correctness)."""
    r, k, v, w, u, _ = (torch.from_numpy(a).to(device)
                        for a in _wkv_inputs(1, 24, 2, 32, seed=7))
    s0 = torch.zeros((1, 2, 32, 32), device=device)
    y_full, s_full = fn(r, k, v, w, u, s0)
    t1 = 10
    y1, s1 = fn(r[:, :t1], k[:, :t1], v[:, :t1], w[:, :t1], u, s0)
    y2, s2 = fn(r[:, t1:], k[:, t1:], v[:, t1:], w[:, t1:], u, s1)
    torch.testing.assert_close(torch.cat([y1, y2], dim=1), y_full,
                               **WKV_TOL)
    torch.testing.assert_close(s2, s_full, **WKV_TOL)
    # the model's call: state_T written over state0 in place
    s_io = s0.clone()
    y_io, s_ret = fn(r, k, v, w, u, s_io, s_io)
    assert s_ret.data_ptr() == s_io.data_ptr()
    torch.testing.assert_close(y_io, y_full, **WKV_TOL)
    torch.testing.assert_close(s_io, s_full, **WKV_TOL)


def test_wkv6_ref_state_carry_composes():
    _wkv_composes(ref.wkv6_ref)


def test_wkv6_scan_writes_state_out_on_cpu():
    arrs = [torch.from_numpy(a) for a in _wkv_inputs(2, 5, 2, 32)]
    want_y, want_s = ref.wkv6_ref(*arrs)
    out = torch.full_like(arrs[5], float("nan"))
    y, s_t = ops.wkv6_scan(*arrs, state_out=out)
    assert s_t is out
    torch.testing.assert_close(y, want_y, rtol=0, atol=0)
    torch.testing.assert_close(out, want_s, rtol=0, atol=0)


# ---------------------------------------------------------------------------
# SNAKE decode GEMM
# ---------------------------------------------------------------------------
GEMM_SHAPES = [
    (1, 128, 128), (8, 512, 256), (8, 2048, 8192), (13, 257, 129),
    (16, 4096, 512), (32, 300, 5000), (64, 1024, 2048), (100, 640, 384),
]
GEMM_DTYPES = ["float32", "bfloat16"]


def _gemm_tol(dtype):
    # tests/test_kernels.py's: f32 allows blocked-K reassociation at K up
    # to 16k; bf16 rounds the f32 result once
    return (dict(rtol=2e-2, atol=2e-2) if dtype == "bfloat16"
            else dict(rtol=5e-3, atol=1e-3))


def _gemm_inputs(m, n, k):
    rng = np.random.default_rng(m + n + k)
    return (rng.standard_normal((m, k)).astype(np.float32),
            rng.standard_normal((k, n)).astype(np.float32))


@pytest.mark.parametrize("m,n,k", GEMM_SHAPES)
@pytest.mark.parametrize("dtype", GEMM_DTYPES)
def test_decode_gemm_ref_matches_pallas(m, n, k, dtype):
    (aj, at), (bj, bt) = (_pair(x, dtype) for x in _gemm_inputs(m, n, k))
    want = snake_decode_gemm(aj, bj, interpret=True)
    got = ref.decode_gemm_ref(at, bt)
    assert got.dtype == at.dtype and got.shape == (m, n)
    np.testing.assert_allclose(got.float().numpy(),
                               np.asarray(want, np.float32),
                               **_gemm_tol(dtype))


def test_mapping_follows_paper_rule():
    """IS when N > K and the block's rows of A fit; OS when K >= N or A
    does not fit a Hopper block (paper §3.1, restated for 227 KB)."""
    bf16, f32 = torch.bfloat16, torch.float32
    assert sg.choose_mapping(8, 28672, 4096, bf16).dataflow == "IS"
    assert sg.choose_mapping(8, 4096, 28672, bf16).dataflow == "OS"
    assert sg.choose_mapping(8, 8192, 28672, f32).dataflow == "OS"
    # 8 f32 rows of K = 8192 are 256 KB: more than a block holds, so OS
    # here where the TPU mapping picks IS
    assert sg.choose_mapping(8, 28672, 8192, f32).dataflow == "OS"
    # rwkv6-7b's decode products at a batch of 4
    assert sg.choose_mapping(4, 14336, 4096, bf16).dataflow == "IS"
    assert sg.choose_mapping(4, 4096, 14336, bf16).dataflow == "OS"
    assert sg.choose_mapping(4, 4096, 4096, bf16).dataflow == "OS"
    assert ops.decode_gemm_mapping(4, 14336, 4096) == \
        sg.choose_mapping(4, 14336, 4096, bf16)


@pytest.mark.parametrize("m,dtype,want", [
    (3, torch.float32, 8), (3, torch.bfloat16, 16), (8, torch.float32, 8),
    (13, torch.float32, 16), (13, torch.bfloat16, 16),
    (100, torch.bfloat16, 112)])
def test_mapping_pads_m_to_granularity(m, dtype, want):
    assert sg.choose_mapping(m, 1024, 1024, dtype).block_m == want


def test_mapping_blocks_fit_the_block_budget():
    shapes = GEMM_SHAPES + [(4, 4096, 4096), (4, 14336, 4096),
                            (4, 4096, 14336), (8, 28672, 8192)]
    for m, n, k in shapes:
        for dt in (torch.float32, torch.bfloat16):
            mp = sg.choose_mapping(m, n, k, dt)
            assert mp.smem_bytes(dt) <= sg.SMEM_BUDGET, (m, n, k, dt, mp)
            assert mp.block_k == k if mp.dataflow == "IS" \
                else 0 < mp.block_k <= sg.MAX_BLOCK_K


def test_new_wrappers_take_the_plain_path_on_cpu():
    wk.reset_launches()
    sg.reset_launches()
    arrs = [torch.from_numpy(a) for a in _wkv_inputs(2, 5, 2, 32)]
    y, s_t = ops.wkv6_scan(*arrs)
    yr, sr = ref.wkv6_ref(*arrs)
    torch.testing.assert_close(y, yr, rtol=0, atol=0)
    torch.testing.assert_close(s_t, sr, rtol=0, atol=0)
    a, b = (torch.from_numpy(x) for x in _gemm_inputs(4, 64, 32))
    torch.testing.assert_close(ops.decode_gemm(a, b),
                               ref.decode_gemm_ref(a, b), rtol=0, atol=0)
    assert wk.LAUNCHES == {"wkv6": 0}
    assert sg.LAUNCHES == {"snake_decode_gemm_is": 0,
                           "snake_decode_gemm_os": 0}
    with pytest.raises(ValueError):
        ops.wkv6_scan(*(t.to("meta") for t in arrs))
    with pytest.raises(ValueError):
        ops.decode_gemm(a.to("meta"), b.to("meta"))


def _bad_wkv_inputs():
    r, k, v, w, u, s0 = (torch.from_numpy(a) for a in
                         _wkv_inputs(2, 3, 2, 32))
    return {
        "head_size_48": tuple(torch.zeros(2, 3, 2, 48) for _ in range(4))
        + (torch.zeros(2, 48), torch.zeros(2, 2, 48, 48)),
        "float16": (r.half(), k.half(), v.half(), w.half(), u.half(), s0),
        "mixed_dtypes": (r, k.bfloat16(), v, w, u, s0),
        "bf16_state": (r, k, v, w, u, s0.bfloat16()),
        "state_shape": (r, k, v, w, u, s0[:1]),
        "u_shape": (r, k, v, w, u[:1], s0),
        "strided_last_dim": tuple(t.transpose(2, 3).contiguous()
                                  .transpose(2, 3) for t in (r, k, v, w))
        + (u, s0),
        "unshared_strides": (r, k.transpose(1, 2).contiguous()
                             .transpose(1, 2), v, w, u, s0),
    }


@pytest.mark.parametrize("case", sorted(_bad_wkv_inputs()))
def test_wkv6_check_args_refuses(case):
    with pytest.raises(ValueError):
        wk.check_args(*_bad_wkv_inputs()[case])


def test_wkv6_check_args_accepts_model_layouts():
    arrs = [torch.from_numpy(a) for a in _wkv_inputs(2, 3, 2, 32)]
    wk.check_args(*arrs)
    states = torch.zeros(4, 2, 2, 32, 32)      # a layer slice of (L, ...)
    wk.check_args(*arrs[:5], states[3])
    wk.check_args(*(t.bfloat16() for t in arrs[:5]), states[0])


@pytest.mark.parametrize("case", ["shape", "dtype", "strided", "mapping"])
def test_gemm_check_args_refuses(case):
    a, b = (torch.from_numpy(x) for x in _gemm_inputs(4, 64, 32))
    mp = sg.choose_mapping(4, 64, 32, torch.float32)
    args = {"shape": (a, b[:16], mp),
            "dtype": (a.half(), b.half(), mp),
            "strided": (a, b.t().contiguous().t(), mp),
            "mapping": (a, b, sg.GemmMapping("IS", 8, sg.BLOCK_N, 16))}
    with pytest.raises(ValueError):
        sg.check_args(*args[case])


def test_new_cuda_wrappers_refuse_cpu_tensors():
    arrs = [torch.from_numpy(a) for a in _wkv_inputs(1, 2, 1, 32)]
    with pytest.raises(ValueError, match="CUDA"):
        wk.wkv6(*arrs)
    a, b = (torch.from_numpy(x) for x in _gemm_inputs(4, 64, 32))
    with pytest.raises(ValueError, match="CUDA"):
        sg.snake_decode_gemm(a, b)
    assert wk.LAUNCHES["wkv6"] == 0
    assert not any(sg.LAUNCHES.values())


def _need_cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (the kernels have no CPU mode)")


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("b,t,h,hs", WKV_SHAPES + [(3, 1, 5, 64)])
def test_cuda_wkv6_matches_plain(b, t, h, hs, dtype):
    _need_cuda()
    arrs = [torch.from_numpy(a).cuda() for a in _wkv_inputs(b, t, h, hs)]
    r, k, v, w, u = (x.to(getattr(torch, dtype)) for x in arrs[:5])
    y, s_t = wk.wkv6(r, k, v, w, u, arrs[5])
    yr, sr = ref.wkv6_ref(r, k, v, w, u, arrs[5])
    tol = WKV_TOL if dtype == "float32" else dict(rtol=2e-2, atol=2e-2)
    assert y.dtype == r.dtype
    torch.testing.assert_close(y.float(), yr.float(), **tol)
    torch.testing.assert_close(s_t, sr, **tol)


@pytest.mark.cuda
def test_cuda_wkv6_state_carry_composes():
    _need_cuda()
    _wkv_composes(wk.wkv6, device="cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("dataflow", ["chosen", "IS", "OS"])
@pytest.mark.parametrize("dtype", GEMM_DTYPES)
@pytest.mark.parametrize("m,n,k", GEMM_SHAPES)
def test_cuda_gemm_matches_plain(m, n, k, dtype, dataflow):
    _need_cuda()
    dt = getattr(torch, dtype)
    a, b = (torch.from_numpy(x).cuda().to(dt) for x in _gemm_inputs(m, n, k))
    mp = sg.choose_mapping(m, n, k, dt)
    if dataflow == "IS":
        mp = sg.GemmMapping("IS", mp.block_m, sg.BLOCK_N, k)
        if mp.smem_bytes(dt) > sg.SMEM_BUDGET:
            with pytest.raises(ValueError):     # A does not fit one block
                sg.snake_decode_gemm(a, b, mp)
            return
    elif dataflow == "OS":
        mp = sg.GemmMapping("OS", mp.block_m, sg.BLOCK_N, 256)
    got = sg.snake_decode_gemm(a, b, mp)
    torch.testing.assert_close(got.float(), ref.decode_gemm_ref(a, b).float(),
                               **_gemm_tol(dtype))
