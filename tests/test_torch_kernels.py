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


def _paged_case(g, dtype, seed=0, hkv=2, d=32, page=4,
                lengths=(0, 7, 13), nblk=4):
    """Pools with pages dealt in shuffled order, the tail of each
    slot's last page and the scratch page filled with garbage."""
    rng = np.random.default_rng(seed)
    b = len(lengths)
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


# the widened head dims (stablelm-3b D = 80, kimi-k2 D = 112) at the
# group sizes of mixtral / dbrx (G = 6) and qwen2-vl (G = 7)
WIDE = [(80, 6), (80, 7), (112, 6), (112, 7)]


@pytest.mark.parametrize("d,g", WIDE)
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_wide_paged_ref_matches_pallas(d, g, dtype):
    q, kp, vp, tables, lengths = _paged_case(g, dtype, seed=d + g, d=d)
    (qj, qt), (kj, kt), (vj, vt) = (_pair(a, dtype) for a in (q, kp, vp))
    want = paged_flash_decode(qj, kj, vj, jnp.asarray(tables),
                              jnp.asarray(lengths), interpret=True)
    got = ref.paged_flash_decode_ref(qt, kt, vt, torch.from_numpy(tables),
                                     torch.from_numpy(lengths))
    np.testing.assert_allclose(got.float().numpy(),
                               np.asarray(want, np.float32), **_tol(dtype))
    assert not got[0].any()
    fd.check_args(qt, kt, vt, torch.from_numpy(lengths),
                  torch.from_numpy(tables))


@pytest.mark.parametrize("d,g", WIDE)
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_wide_split_ref_matches_dense_pallas(d, g, dtype):
    chunk = 16
    q, k, v, lengths = _dense_case(g, _edges(chunk), d=d, s=64, seed=d + g)
    (qj, qt), (kj, kt), (vj, vt) = (_pair(a, dtype) for a in (q, k, v))
    lt = torch.from_numpy(lengths)
    got = ref.flash_decode_split_ref(qt, kt, vt, lt, chunk)
    want = flash_decode(qj, kj, vj, jnp.asarray(lengths), block_s=16,
                        interpret=True)
    np.testing.assert_allclose(got.float().numpy(),
                               np.asarray(want, np.float32), **_tol(dtype))
    fd.check_args(qt, kt, vt, lt)


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
        "group_32": (torch.zeros(3, 64, 32), kp, vp, tables, lengths),
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


def _edges(c):
    """Lengths at the edges of chunks of ``c`` positions, and one lane
    over several chunks."""
    return (0, 1, c - 1, c, c + 1, 3 * c + 5)


@pytest.mark.cuda
@pytest.mark.parametrize("case", ["small", "edges_16", "edges_planned"])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("g", [1, 4, 8])
def test_cuda_kernels_match_plain(dtype, g, case):
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (the kernels have no CPU mode)")
    esize = 4 if dtype == "float32" else 2
    nblk = 32                      # cap 128 at page 4
    planned, _ = fd.split_plan(128, 6, 2, 4, 64 * esize)
    chunk, lengths = {"small": (None, (0, 7, 13)),
                      "edges_16": (16, _edges(16)),
                      "edges_planned": (None, _edges(planned))}[case]
    q, kp, vp, tables, lengths = (torch.from_numpy(a).cuda() for a in
                                  _paged_case(g, dtype, d=64,
                                              lengths=lengths, nblk=nblk))
    q, kp, vp = (t.to(getattr(torch, dtype)) for t in (q, kp, vp))
    b = q.shape[0]
    got = fd.paged_flash_decode(q, kp, vp, tables, lengths, chunk)
    want = ref.paged_flash_decode_ref(q, kp, vp, tables, lengths)
    torch.testing.assert_close(got.float(), want.float(), **_tol(dtype))
    assert not got[0].any()
    k = kp[tables.long()].reshape(b, -1, *kp.shape[2:]).contiguous()
    v = vp[tables.long()].reshape(b, -1, *vp.shape[2:]).contiguous()
    got = fd.flash_decode(q, k, v, lengths, chunk)
    torch.testing.assert_close(got.float(), want.float(), **_tol(dtype))
    assert not got[0].any()


@pytest.mark.cuda
@pytest.mark.parametrize("case", ["small", "edges_16", "edges_planned"])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("d,g", WIDE)
def test_cuda_wide_kernels_match_plain(d, g, dtype, case):
    """D = 80 / 112 (rows of 10 / 14 bf16 pieces, an odd count of
    16-wide tensor-core tiles) at G = 6 / 7 (heads padded to 8)."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (the kernels have no CPU mode)")
    esize = 4 if dtype == "float32" else 2
    nblk = 64                      # cap 256 at page 4
    planned, _ = fd.split_plan(256, 6, 2, 4, d * esize)
    chunk, lengths = {"small": (None, (0, 7, 13)),
                      "edges_16": (16, _edges(16)),
                      "edges_planned": (None, _edges(planned))}[case]
    q, kp, vp, tables, lengths = (torch.from_numpy(a).cuda() for a in
                                  _paged_case(g, dtype, d=d,
                                              lengths=lengths, nblk=nblk))
    q, kp, vp = (t.to(getattr(torch, dtype)) for t in (q, kp, vp))
    b = q.shape[0]
    got = fd.paged_flash_decode(q, kp, vp, tables, lengths, chunk)
    want = ref.paged_flash_decode_ref(q, kp, vp, tables, lengths)
    torch.testing.assert_close(got.float(), want.float(), **_tol(dtype))
    assert not got[0].any()
    k = kp[tables.long()].reshape(b, -1, *kp.shape[2:]).contiguous()
    v = vp[tables.long()].reshape(b, -1, *vp.shape[2:]).contiguous()
    got = fd.flash_decode(q, k, v, lengths, chunk)
    torch.testing.assert_close(got.float(), want.float(), **_tol(dtype))
    assert not got[0].any()


# ---------------------------------------------------------------------------
# Split-context flash decode: the plan and the two-pass plain rendering
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("page", [1, 2, 4, 8, 16, 32])
@pytest.mark.parametrize("cap", [1, 16, 100, 770, 800, 4096, 32768])
def test_split_plan_chunks_cover_the_cap(page, cap):
    c, n = fd.split_plan(cap, 4, 4, page)
    assert c % page == 0 and c % 16 == 0 and 16 <= c <= 256
    assert n * c >= cap > (n - 1) * c


@pytest.mark.parametrize("batch,lengths,cap", [
    (4, [770] * 4, 770),                          # the serve's decode step
    (4, [768, 771, 775, 778], 800),
    (8, [0, 1, 16, 17, 255, 1000, 2048, 4096], 4096),   # chip_smoke's
])
def test_split_plan_fills_one_wave(batch, lengths, cap):
    hkv, page = 4, 16
    c, n = fd.split_plan(cap, batch, hkv, page)
    assert hkv * sum(-(-x // c) for x in lengths) >= 132
    assert n == -(-cap // c)


def test_split_plan_keeps_a_chunk_in_shared_memory():
    for row_bytes in (64, 128, 256, 512):         # D * element size
        for cap in (32, 1000, 10**5):
            c, _ = fd.split_plan(cap, 1, 1, 16, row_bytes)
            assert c * row_bytes <= fd.MAX_TILE_BYTES
    assert fd.split_plan(4096, 8, 4, 16, 256, chunk=64) == (64, 64)
    for bad in (8, 24, 512):
        with pytest.raises(ValueError):
            fd.split_plan(4096, 8, 4, 16, 256, chunk=bad)
    with pytest.raises(ValueError):                # f32 D=128: 128 KB
        fd.split_plan(4096, 8, 4, 16, 512, chunk=256)
    with pytest.raises(ValueError):                # the grid's z limit
        fd.split_plan(10**7, 1, 1, 16, 256, chunk=32)


# the reference's flash-decode test shapes (tests/test_kernels.py
# FD_SHAPES): (B, Hq, Hkv, D, S); (2, 16, 1, 256, 300) is
# recurrentgemma-9b's MQA attention, D = 256 and G = 16
FD_SHAPES = [
    (2, 8, 2, 64, 512), (1, 32, 4, 128, 2048), (3, 12, 12, 64, 600),
    (2, 16, 1, 256, 300), (1, 128, 128, 64, 256),
]
#: a block's opt-in shared memory on the H100 (flash_decode.cu kMaxSmem)
MAX_SMEM = 232448


def _smem_bytes(d, esize, chunk, group_cap):
    """The partial kernel's dynamic shared memory, as flash_decode.cu
    lays it out (``MmaSmem::bytes`` for bf16, ``Smem::bytes`` for f32):
    K and V rows padded by 16 bytes, then the group's rows (q, scores and,
    in bf16, the probabilities), then the chunk's page ids."""
    row = d * esize + 16
    scores = (chunk + 4) * 4
    if esize == 2:
        heads = group_cap * row + group_cap * (scores + 2 * chunk + 16)
    else:
        heads = group_cap * d * 4 + group_cap * scores
    return 2 * chunk * row + heads + (chunk + 1) * 4


def _reference_tol(dtype):
    """tests/test_kernels.py's flash-decode tolerances."""
    return (dict(rtol=2e-2, atol=2e-2) if dtype == "bfloat16"
            else dict(rtol=5e-3, atol=1e-3))


def _reference_case(b, hq, hkv, d, s, page=16, seed=0):
    """q, dense k/v, page pools dealt in a shuffled order and the tables
    over them (page ``page``, unmapped entries on the scratch page), and
    the reference test's lengths ``max(1, s - 13 i)``; garbage past every
    length and in the scratch page."""
    rng = np.random.default_rng(seed)
    lengths = np.asarray([max(1, s - 13 * i) for i in range(b)], np.int32)
    q = rng.standard_normal((b, hq, d)).astype(np.float32)
    k, v = rng.standard_normal((2, b, s, hkv, d)).astype(np.float32)
    for i, n in enumerate(lengths):
        k[i, n:] = v[i, n:] = GARBAGE
    nblk = -(-s // page)
    n_pages = b * nblk
    order = rng.permutation(n_pages)
    kp = np.full((n_pages + 1, page, hkv, d), GARBAGE, np.float32)
    vp = kp.copy()
    tables = np.full((b, nblk), n_pages, np.int32)
    for i, n in enumerate(lengths):
        for j in range(-(-n // page)):
            pg = order[i * nblk + j]
            tables[i, j] = pg
            span = slice(j * page, min((j + 1) * page, s))
            kp[pg, :span.stop - span.start] = k[i, span]
            vp[pg, :span.stop - span.start] = v[i, span]
    return q, k, v, kp, vp, tables, lengths


@pytest.mark.parametrize("b,hq,hkv,d,s", FD_SHAPES)
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_kernels_take_the_reference_shapes(b, hq, hkv, d, s, dtype):
    """check_args accepts every reference shape in both layouts, and the
    plan's chunk keeps a block inside the card's shared memory at the
    group capacity the kernel picks (16 rows of heads above G = 8)."""
    q, k, v, kp, vp, tables, lengths = (
        torch.from_numpy(a) for a in _reference_case(b, hq, hkv, d, s))
    q, k, v, kp, vp = (t.to(getattr(torch, dtype)) for t in (q, k, v, kp, vp))
    fd.check_args(q, k, v, lengths)
    fd.check_args(q, kp, vp, lengths, tables)
    esize = q.element_size()
    cap = 8 if hq // hkv <= 8 else 16
    for page, ctx in ((1, s), (16, tables.shape[1] * 16)):
        c, n_split = fd.split_plan(ctx, b, hkv, page, d * esize)
        assert c % page == 0 and n_split * c >= ctx
        assert _smem_bytes(d, esize, c, cap) <= MAX_SMEM


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_split_plan_fits_shared_memory_at_group_16(dtype):
    """Every chunk split_plan may pick, at every head dim, fits one
    block's shared memory with 16 rows of heads: at D = 256 a bf16 row is
    512 B (chunks up to 128, ~157 KB) and an f32 row 1 KB (up to 64,
    ~154 KB)."""
    esize = 2 if dtype == "bfloat16" else 4
    for d in fd.HEAD_DIMS:
        fits = [c for c in fd.CHUNKS if c * d * esize <= fd.MAX_TILE_BYTES]
        assert fits, d
        for c in fits:
            assert _smem_bytes(d, esize, c, 16) <= MAX_SMEM, (d, c)
        for cap in (16, 300, 4096):
            got, _ = fd.split_plan(cap, 2, 1, 16, d * esize)
            assert got in fits
    assert max(c for c in fd.CHUNKS if c * 256 * esize
               <= fd.MAX_TILE_BYTES) == (128 if esize == 2 else 64)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_wide_group_plain_matches_pallas(dtype):
    """The plain versions at recurrentgemma-9b's attention (D = 256,
    Hq = 16, Hkv = 1) against the Pallas kernels in interpret mode, dense
    and paged."""
    q, k, v, kp, vp, tables, lengths = _reference_case(2, 16, 1, 256, 300)
    (qj, qt), (kj, kt), (vj, vt) = (_pair(a, dtype) for a in (q, k, v))
    (kpj, kpt), (vpj, vpt) = (_pair(a, dtype) for a in (kp, vp))
    lt, tt = torch.from_numpy(lengths), torch.from_numpy(tables)
    got = ref.flash_decode_ref(qt, kt, vt, lt)
    want = flash_decode(qj, kj, vj, jnp.asarray(lengths), block_s=256,
                        interpret=True)
    np.testing.assert_allclose(got.float().numpy(),
                               np.asarray(want, np.float32),
                               **_reference_tol(dtype))
    got = ref.paged_flash_decode_ref(qt, kpt, vpt, tt, lt)
    want = paged_flash_decode(qj, kpj, vpj, jnp.asarray(tables),
                              jnp.asarray(lengths), interpret=True)
    np.testing.assert_allclose(got.float().numpy(),
                               np.asarray(want, np.float32),
                               **_reference_tol(dtype))


@pytest.mark.cuda
@pytest.mark.parametrize("b,hq,hkv,d,s", FD_SHAPES)
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_cuda_kernels_hold_the_reference_shapes(b, hq, hkv, d, s, dtype):
    """Both kernels at the reference's five test shapes, lengths
    ``max(1, s - 13 i)``, paged at page 16, within tests/test_kernels.py's
    tolerances of the plain versions."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (the kernels have no CPU mode)")
    q, k, v, kp, vp, tables, lengths = (
        torch.from_numpy(a).cuda() for a in _reference_case(b, hq, hkv, d, s))
    q, k, v, kp, vp = (t.to(getattr(torch, dtype)) for t in (q, k, v, kp, vp))
    tol = _reference_tol(dtype)
    want = ref.flash_decode_ref(q, k, v, lengths).float()
    torch.testing.assert_close(fd.flash_decode(q, k, v, lengths).float(),
                               want, **tol)
    got = fd.paged_flash_decode(q, kp, vp, tables, lengths).float()
    torch.testing.assert_close(
        got, ref.paged_flash_decode_ref(q, kp, vp, tables, lengths).float(),
        **tol)
    torch.testing.assert_close(got, want, **tol)


def _dense_case(g, lengths, d=32, hkv=2, s=None, seed=3):
    rng = np.random.default_rng(seed)
    b = len(lengths)
    s = s or max(lengths)
    q = rng.standard_normal((b, hkv * g, d)).astype(np.float32)
    k = rng.standard_normal((b, s, hkv, d)).astype(np.float32)
    v = rng.standard_normal((b, s, hkv, d)).astype(np.float32)
    for i, n in enumerate(lengths):
        k[i, n:] = v[i, n:] = GARBAGE
    return q, k, v, np.asarray(lengths, np.int32)


@pytest.mark.parametrize("g", [1, 4, 8])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_split_ref_matches_dense_plain_and_pallas(g, dtype):
    chunk = 16
    q, k, v, lengths = _dense_case(g, _edges(chunk), s=64)
    (qj, qt), (kj, kt), (vj, vt) = (_pair(a, dtype) for a in (q, k, v))
    lt = torch.from_numpy(lengths)
    got = ref.flash_decode_split_ref(qt, kt, vt, lt, chunk)
    assert got.dtype == qt.dtype
    torch.testing.assert_close(got.float(),
                               ref.flash_decode_ref(qt, kt, vt, lt).float(),
                               **_tol(dtype))
    want = flash_decode(qj, kj, vj, jnp.asarray(lengths), block_s=16,
                        interpret=True)
    np.testing.assert_allclose(got.float().numpy(),
                               np.asarray(want, np.float32), **_tol(dtype))
    assert not got[0].any()          # the 0-length lane is exactly 0


@pytest.mark.parametrize("chunk", [16, 32])
@pytest.mark.parametrize("g", [1, 4, 8])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_split_ref_matches_paged_plain_and_pallas(g, dtype, chunk):
    q, kp, vp, tables, lengths = _paged_case(g, dtype, lengths=_edges(chunk),
                                             nblk=-(-(3 * chunk + 5) // 4))
    (qj, qt), (kj, kt), (vj, vt) = (_pair(a, dtype) for a in (q, kp, vp))
    tt, lt = torch.from_numpy(tables), torch.from_numpy(lengths)
    got = ref.paged_flash_decode_split_ref(qt, kt, vt, tt, lt, chunk)
    torch.testing.assert_close(
        got.float(), ref.paged_flash_decode_ref(qt, kt, vt, tt, lt).float(),
        **_tol(dtype))
    want = paged_flash_decode(qj, kj, vj, jnp.asarray(tables),
                              jnp.asarray(lengths), interpret=True)
    np.testing.assert_allclose(got.float().numpy(),
                               np.asarray(want, np.float32), **_tol(dtype))
    assert not got[0].any()


def test_split_partials_of_empty_chunks_are_empty():
    chunk = 16
    q, k, v, lengths = (torch.from_numpy(a) for a in
                        _dense_case(4, _edges(chunk), s=80))
    acc, m, l = ref.decode_partials_ref(q, k, v, lengths, chunk)
    assert acc.shape == (6, 2, 5, 4, 32) and m.shape == l.shape == (6, 2, 5, 4)
    used = torch.arange(5)[None, :] * chunk < lengths[:, None].long()
    assert (l[~used[:, None, :, None].expand_as(l)] == 0).all()
    assert (m[~used[:, None, :, None].expand_as(m)] == ref.NEG).all()
    assert (l[used[:, None, :, None].expand_as(l)] >= 1).all()
    # a chunk's own softmax: its max position contributes exactly 1
    lane, c = 5, 3                   # 53 = 3 * 16 + 5: the last chunk
    s = torch.einsum("gd,pd->gp", q[lane, :4] / 32 ** 0.5,
                     k[lane, 48:53, 0])
    torch.testing.assert_close(m[lane, 0, c], s.amax(-1))
    torch.testing.assert_close(l[lane, 0, c],
                               torch.exp(s - s.amax(-1, True)).sum(-1))


def test_wrappers_read_nothing_back_to_the_host():
    """The split comes from shapes alone, so a call never synchronises
    and stays capturable in a CUDA graph."""
    import inspect
    src = inspect.getsource(fd)
    for call in (".item(", ".cpu(", ".tolist(", ".numpy(", "synchronize"):
        assert call not in src


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


def _chunk_lengths(c):
    return sorted({1, c - 1, c, c + 1, 33})


WKV_CHUNK_CASES = [(c, t, hs) for c in (4, 16) for t in _chunk_lengths(c)
                   for hs in (32, 64, 128)]


@pytest.mark.parametrize("chunk,t,hs", WKV_CHUNK_CASES)
def test_wkv6_chunked_ref_matches_plain_and_pallas(chunk, t, hs):
    """The chunked algorithm is the recurrence: against ref.wkv6_ref and
    the Pallas kernel in interpret mode, over whole chunks and a ragged
    tail."""
    arrs = _wkv_inputs(1, t, 2, hs, seed=t + hs)
    y, s_t = ref.wkv6_chunked_ref(*(torch.from_numpy(a) for a in arrs),
                                  chunk=chunk)
    yr, sr = ref.wkv6_ref(*(torch.from_numpy(a) for a in arrs))
    torch.testing.assert_close(y, yr, **WKV_TOL)
    torch.testing.assert_close(s_t, sr, **WKV_TOL)
    yw, sw = pallas_wkv6(*(jnp.asarray(a) for a in arrs), interpret=True)
    np.testing.assert_allclose(y.numpy(), np.asarray(yw), **WKV_TOL)
    np.testing.assert_allclose(s_t.numpy(), np.asarray(sw), **WKV_TOL)


def _extreme_decays(kind, b, t, h, hs, seed=0):
    """Decays the chunked form must survive: exact zeros, 1e-30, 1e-3 and
    0.9999 mixed; or exp(-exp(x)) for x in [-8, 5] as the model forms it
    (x past ~4.5 underflows to exactly 0 in float32)."""
    rng = np.random.default_rng(seed)
    if kind == "mixed":
        vals = np.array([0.0, 1e-30, 1e-3, 0.9999], np.float32)
        return vals[rng.integers(0, 4, (b, t, h, hs))]
    x = rng.uniform(-8.0, 5.0, (b, t, h, hs)).astype(np.float32)
    return np.exp(-np.exp(x))


@pytest.mark.parametrize("kind", ["mixed", "model"])
@pytest.mark.parametrize("chunk", [4, 16])
@pytest.mark.parametrize("hs", [32, 64])
def test_wkv6_chunked_ref_survives_extreme_decays(kind, chunk, hs):
    r, k, v, _, u, s0 = _wkv_inputs(2, 33, 2, hs, seed=5)
    w = _extreme_decays(kind, 2, 33, 2, hs)
    assert (w == 0).any()
    arrs = (r, k, v, w, u, s0)
    y, s_t = ref.wkv6_chunked_ref(*(torch.from_numpy(a) for a in arrs),
                                  chunk=chunk)
    assert torch.isfinite(y).all() and torch.isfinite(s_t).all()
    yr, sr = ref.wkv6_ref(*(torch.from_numpy(a) for a in arrs))
    torch.testing.assert_close(y, yr, **WKV_TOL)
    torch.testing.assert_close(s_t, sr, **WKV_TOL)
    yw, sw = pallas_wkv6(*(jnp.asarray(a) for a in arrs), interpret=True)
    np.testing.assert_allclose(y.numpy(), np.asarray(yw), **WKV_TOL)
    np.testing.assert_allclose(s_t.numpy(), np.asarray(sw), **WKV_TOL)


@pytest.mark.parametrize("kind", ["uniform", "mixed", "model"])
@pytest.mark.parametrize("chunk,sub,t", [(16, 4, 33), (16, 4, 70),
                                         (64, 16, 70), (64, 16, 129)])
def test_wkv6_chunked_ref_sub_blocks(chunk, sub, t, kind):
    """Chunks of several sub-blocks: the products below the diagonal
    (rtil . khat through the sub-block totals) hold at every decay."""
    r, k, v, w, u, s0 = _wkv_inputs(1, t, 2, 32, seed=t)
    if kind != "uniform":
        w = _extreme_decays(kind, 1, t, 2, 32, seed=t)
    arrs = [torch.from_numpy(a) for a in (r, k, v, w, u, s0)]
    y, s_t = ref.wkv6_chunked_ref(*arrs, chunk=chunk, sub=sub)
    assert torch.isfinite(y).all() and torch.isfinite(s_t).all()
    yr, sr = ref.wkv6_ref(*arrs)
    torch.testing.assert_close(y, yr, **WKV_TOL)
    torch.testing.assert_close(s_t, sr, **WKV_TOL)


@pytest.mark.parametrize("chunk", [4, 16])
def test_wkv6_chunked_ref_state_carry_composes(chunk):
    _wkv_composes(lambda *a: ref.wkv6_chunked_ref(*a, chunk=chunk))


@pytest.mark.parametrize("chunk", wk.CHUNKS)
@pytest.mark.parametrize("t", [1, 2, 15, 16, 17, 63, 64, 65, 768, 1024])
def test_wkv6_chunk_plan_covers_t(t, chunk):
    """Whole chunks and a ragged tail: chunks - 1 full chunks of C steps,
    then 1..C steps."""
    plan = wk.chunk_plan(1, t, 64, 64, torch.float32, chunk)
    assert plan.design == "chunked" and plan.chunk == chunk
    assert plan.blocks == 64 * plan.chunks
    assert (plan.chunks - 1) * chunk < t <= plan.chunks * chunk


def test_wkv6_chunk_plan_by_shape():
    """Decode (T=1) takes the serial design, one block per (b, h); T from
    the threshold on the planned C, one block per (b, h, chunk)."""
    f32 = torch.float32
    assert wk.chunk_plan(4, 1, 64, 64, f32) == ("serial", 0, 256, 0)
    assert wk.chunk_plan(4, wk.CHUNKED_MIN_T - 1, 64, 64,
                         f32).design == "serial"
    for t in (wk.CHUNKED_MIN_T, 768, 1024):
        plan = wk.chunk_plan(1, t, 64, 64, f32)
        assert plan.design == "chunked" and plan.chunk == wk.PLANNED_CHUNK
        assert plan.blocks == 64 * -(-t // wk.PLANNED_CHUNK)
    assert wk.chunk_plan(1, 9, 2, 32, f32, 0).design == "serial"


@pytest.mark.parametrize("chunk,hs,dtype", [
    (8, 64, torch.float32), (48, 64, torch.float32),
    (128, 64, torch.float32), (-16, 64, torch.float32),
    (64, 128, torch.float32), (64, 128, torch.bfloat16)])
def test_wkv6_chunk_plan_refuses_bad_overrides(chunk, hs, dtype):
    """C outside CHUNKS, or a block over the shared memory (C = 64 at
    hs = 128)."""
    with pytest.raises(ValueError):
        wk.chunk_plan(1, 100, 2, hs, dtype, chunk)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_wkv6_chunk_plan_fits_shared_memory(dtype):
    """Every C fits a block's shared memory at hs <= 64, and the planned C
    at every head size."""
    for hs in (32, 64):
        for c in wk.CHUNKS:
            assert wk.chunk_plan(1, 100, 2, hs, dtype, c).chunk == c
    for hs in wk.HEAD_SIZES:
        assert wk.chunk_plan(1, 100, 2, hs, dtype).chunk == wk.PLANNED_CHUNK


def test_wkv6_wrapper_reads_nothing_back_to_the_host():
    """The design comes from shapes alone, so a call never synchronises
    and stays capturable in a CUDA graph."""
    import inspect
    src = inspect.getsource(wk)
    for call in (".item(", ".cpu(", ".tolist(", ".numpy(", "synchronize"):
        assert call not in src


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


GEMM_PLAN_SHAPES = GEMM_SHAPES + [(4, 4096, 4096), (4, 14336, 4096),
                                  (4, 4096, 14336), (16, 14336, 4096),
                                  (8, 28672, 8192), (5, 1001, 333)]


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("m,n,k", GEMM_PLAN_SHAPES)
def test_split_k_plan_covers_k(m, n, k, dtype):
    """The chunks cover K exactly: every one but the last is bk rows, a
    multiple of 16, and the last is not empty; the same for every split
    count the mapping allows."""
    cap = sg.choose_mapping(m, n, k, dtype).block_k
    most = -(-k // sg.K_STEP)
    for split in sorted({None, 1, 2, 3, 7, most // 2 or 1, most}, key=str):
        if split is not None and -(-k // split) > -(-cap // 16) * 16:
            continue                        # beyond the OS chunk cap
        bk, n_split = sg.split_k_plan(m, n, k, dtype, split)
        assert bk % 16 == 0 and bk > 0
        assert (n_split - 1) * bk < k <= n_split * bk
        if split is not None:
            assert n_split <= split


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("m,n,k", GEMM_PLAN_SHAPES)
def test_split_k_plan_fills_the_card(m, n, k, dtype):
    """MIN_BLOCKS blocks wherever K and one wave of resident blocks
    allow, never more than one wave unless the chunk cap forces it, and
    the planned tile fits one block's shared memory."""
    mp = sg.choose_mapping(m, n, k, dtype)
    bk, n_split = sg.split_k_plan(m, n, k, dtype)
    tiles = -(-n // sg.BLOCK_N) * -(-m // sg.row_tile(dtype))
    cap = -(-mp.block_k // 16) * 16
    least = -(-k // cap)
    assert tiles * n_split <= sg.resident_blocks(mp, dtype, bk) \
        or n_split == least
    if tiles * n_split < sg.MIN_BLOCKS and bk > sg.K_STEP:
        # the next plan with more splits would not fit one wave
        split = n_split + 1
        while sg.split_k_plan(m, n, k, dtype, split)[1] == n_split:
            split += 1
        bk2, n2 = sg.split_k_plan(m, n, k, dtype, split)
        assert tiles * n2 > sg.resident_blocks(mp, dtype, bk2)
    assert bk <= cap
    assert mp.smem_bytes(dtype, bk) <= mp.smem_bytes(dtype) \
        <= sg.SMEM_BUDGET


def test_split_k_plan_at_the_decode_shapes():
    """rwkv6-7b's decode products at a batch of 4, bf16: 128-column
    tiles, K dealt evenly over the fewest splits giving 2 x 132 blocks,
    no more than one wave holds."""
    bf16 = torch.bfloat16
    assert sg.split_k_plan(4, 4096, 14336, bf16) == (1792, 8)   # 256
    assert sg.split_k_plan(4, 4096, 4096, bf16) == (512, 8)     # 256
    # 2 splits would be 224 blocks of 136 KB: 1 a SM, 132 at once
    assert sg.split_k_plan(4, 14336, 4096, bf16) == (4096, 1)   # 112
    whole = sg.GemmMapping("OS", 16, sg.BLOCK_N, 14336)
    assert sg.split_k_plan(4, 4096, 14336, bf16, 1, whole) == (14336, 1)


@pytest.mark.parametrize("split,block_k", [
    (0, None), (-1, None), (897, None),         # outside [1, ceil(K/16)]
    (1, None), (6, None),                       # chunks above OS's 2048
    (2, 4096)])                                 # above a caller's cap
def test_split_k_plan_refuses_bad_overrides(split, block_k):
    mp = block_k and sg.GemmMapping("OS", 16, sg.BLOCK_N, block_k)
    with pytest.raises(ValueError, match="split"):
        sg.split_k_plan(4, 4096, 14336, torch.bfloat16, split, mp)


@pytest.mark.parametrize("dtype", GEMM_DTYPES)
@pytest.mark.parametrize("m,n,k", GEMM_SHAPES)
def test_decode_gemm_split_ref_matches_plain_and_pallas(m, n, k, dtype):
    """The plain rendering of the split (chunk partials summed in split
    order) is the same function as the unsplit product and the Pallas
    kernel in interpret mode, at 1, 2, 3 and the planned split count."""
    (aj, at), (bj, bt) = (_pair(x, dtype) for x in _gemm_inputs(m, n, k))
    want = np.asarray(snake_decode_gemm(aj, bj, interpret=True), np.float32)
    plain = ref.decode_gemm_ref(at, bt).float().numpy()
    planned = sg.split_k_plan(m, n, k, at.dtype)[1]
    for split in sorted({1, 2, 3, planned}):
        bk = (-(-k // split) + 15) // 16 * 16
        got = ref.decode_gemm_split_ref(at, bt, bk)
        assert got.dtype == at.dtype and got.shape == (m, n)
        np.testing.assert_allclose(got.float().numpy(), plain,
                                   **_gemm_tol(dtype))
        np.testing.assert_allclose(got.float().numpy(), want,
                                   **_gemm_tol(dtype))


def test_gemm_wrapper_reads_nothing_back_to_the_host():
    """The split comes from shapes alone, so a call never synchronises
    and stays capturable in a CUDA graph."""
    import inspect
    src = inspect.getsource(sg)
    for call in (".item(", ".cpu(", ".tolist(", ".numpy(", "synchronize"):
        assert call not in src


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
    assert wk.LAUNCHES == {"wkv6": 0, "wkv6_chunked": 0}
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


@pytest.mark.parametrize("case", ["shape", "dtype", "strided", "mapping",
                                  "os_block_k"])
def test_gemm_check_args_refuses(case):
    a, b = (torch.from_numpy(x) for x in _gemm_inputs(4, 64, 32))
    mp = sg.choose_mapping(4, 64, 32, torch.float32)
    args = {"shape": (a, b[:16], mp),
            "dtype": (a.half(), b.half(), mp),
            "strided": (a, b.t().contiguous().t(), mp),
            "mapping": (a, b, sg.GemmMapping("IS", 8, sg.BLOCK_N, 16)),
            "os_block_k": (a, b, sg.GemmMapping("OS", 8, sg.BLOCK_N, 24))}
    with pytest.raises(ValueError):
        sg.check_args(*args[case])


def test_new_cuda_wrappers_refuse_cpu_tensors():
    arrs = [torch.from_numpy(a) for a in _wkv_inputs(1, 2, 1, 32)]
    with pytest.raises(ValueError, match="CUDA"):
        wk.wkv6(*arrs)
    a, b = (torch.from_numpy(x) for x in _gemm_inputs(4, 64, 32))
    with pytest.raises(ValueError, match="CUDA"):
        sg.snake_decode_gemm(a, b)
    assert wk.LAUNCHES == {"wkv6": 0, "wkv6_chunked": 0}
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


WKV_CUDA_CHUNK_CASES = [
    (c, t, hs, dt) for c in wk.CHUNKS for t in (c - 1, c + 1, 3 * c + 5)
    for hs in wk.HEAD_SIZES for dt in ("float32", "bfloat16")
    if wk.smem_bytes(hs, c, getattr(torch, dt)) <= wk.MAX_SMEM]


def _wkv_cuda(arrs, dtype="float32"):
    """numpy inputs on the card, r/k/v/w/u in ``dtype``, state float32."""
    ts = [torch.from_numpy(np.ascontiguousarray(a)).cuda() for a in arrs]
    return [x.to(getattr(torch, dtype)) for x in ts[:5]] + ts[5:]


@pytest.mark.cuda
@pytest.mark.parametrize("chunk,t,hs,dtype", WKV_CUDA_CHUNK_CASES)
def test_cuda_wkv6_chunked_matches_plain(chunk, t, hs, dtype):
    """The chunked kernel at every C, over ragged T, against the plain
    recurrence and the plain rendering of the chunked algorithm."""
    _need_cuda()
    args = _wkv_cuda(_wkv_inputs(2, t, 3, hs, seed=t), dtype)
    y, s_t = wk.wkv6(*args, chunk=chunk)
    tol = WKV_TOL if dtype == "float32" else dict(rtol=2e-2, atol=2e-2)
    for yr, sr in (ref.wkv6_ref(*args),
                   ref.wkv6_chunked_ref(*args, chunk=chunk)):
        torch.testing.assert_close(y.float(), yr.float(), **tol)
        torch.testing.assert_close(s_t, sr, **tol)


@pytest.mark.cuda
@pytest.mark.parametrize("kind", ["mixed", "model"])
@pytest.mark.parametrize("chunk", wk.CHUNKS)
def test_cuda_wkv6_chunked_survives_extreme_decays(kind, chunk):
    _need_cuda()
    r, k, v, _, u, s0 = _wkv_inputs(2, 3 * chunk + 5, 2, 64, seed=9)
    w = _extreme_decays(kind, *r.shape)
    args = _wkv_cuda((r, k, v, w, u, s0))
    y, s_t = wk.wkv6(*args, chunk=chunk)
    assert torch.isfinite(y).all() and torch.isfinite(s_t).all()
    yr, sr = ref.wkv6_ref(*args)
    torch.testing.assert_close(y, yr, **WKV_TOL)
    torch.testing.assert_close(s_t, sr, **WKV_TOL)


@pytest.mark.cuda
@pytest.mark.parametrize("chunk", wk.CHUNKS)
def test_cuda_wkv6_chunked_state_carry_composes(chunk):
    """T1 + T2 == T2 after T1, and state_out is state0, on the chunked
    design (T = 24 cuts into 10 + 14)."""
    _need_cuda()
    _wkv_composes(lambda *a: wk.wkv6(*a, chunk=chunk), device="cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("chunk", [0, *wk.CHUNKS])
def test_cuda_wkv6_graph_replay_is_bitwise(chunk):
    """A CUDA-graph replay of a call gives the bits of a direct call."""
    _need_cuda()
    args = _wkv_cuda(_wkv_inputs(1, 200, 4, 64, seed=4))
    y, s_t = wk.wkv6(*args, chunk=chunk)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        y_g, s_g = wk.wkv6(*args, chunk=chunk)
    y_g.zero_()
    graph.replay()
    torch.cuda.synchronize()
    assert torch.equal(y_g, y) and torch.equal(s_g, s_t)


@pytest.mark.cuda
@pytest.mark.parametrize("chunk", [0, 16])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_cuda_wkv6_rows_off_16_bytes(chunk, dtype):
    """Rows whose start is not 16-byte aligned are staged element by
    element (no cp.async)."""
    _need_cuda()
    arrs = _wkv_inputs(2, 37, 3, 32, seed=2)
    wide = [np.concatenate([np.zeros_like(a[..., :1]), a], -1)
            for a in arrs[:4]]
    args = _wkv_cuda(wide + list(arrs[4:]), dtype)
    args[:4] = [x[..., 1:] for x in args[:4]]
    y, s_t = wk.wkv6(*args, chunk=chunk)
    yr, sr = ref.wkv6_ref(*args)
    tol = WKV_TOL if dtype == "float32" else dict(rtol=2e-2, atol=2e-2)
    torch.testing.assert_close(y.float(), yr.float(), **tol)
    torch.testing.assert_close(s_t, sr, **tol)


@pytest.mark.cuda
def test_cuda_wkv6_counts_each_design():
    _need_cuda()
    wk.reset_launches()
    wk.wkv6(*_wkv_cuda(_wkv_inputs(2, 1, 2, 64)))
    wk.wkv6(*_wkv_cuda(_wkv_inputs(2, wk.CHUNKED_MIN_T, 2, 64)))
    assert wk.LAUNCHES == {"wkv6": 2, "wkv6_chunked": 1}


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


def _split_cases(m, n, k, dt, dataflow):
    """The mapping of ``dataflow`` for (m, n, k) with OS allowed to walk
    all of K, and every distinct plan of the split counts 1 to ceil(K /
    16); None where IS does not fit one block."""
    bm = sg.choose_mapping(m, n, k, dt).block_m
    mp = sg.GemmMapping(dataflow, bm, sg.BLOCK_N,
                        k if dataflow == "IS" else -(-k // 16) * 16)
    if mp.smem_bytes(dt) > sg.SMEM_BUDGET:
        return mp, None
    plans = {}
    for split in range(1, -(-k // 16) + 1):
        plans.setdefault(sg.split_k_plan(m, n, k, dt, split, mp), split)
    return mp, plans


@pytest.mark.cuda
@pytest.mark.parametrize("dataflow", ["IS", "OS"])
@pytest.mark.parametrize("dtype", GEMM_DTYPES)
@pytest.mark.parametrize("m,n,k", GEMM_SHAPES)
def test_cuda_gemm_every_split_matches_plain(m, n, k, dtype, dataflow):
    _need_cuda()
    dt = getattr(torch, dtype)
    a, b = (torch.from_numpy(x).cuda().to(dt) for x in _gemm_inputs(m, n, k))
    mp, plans = _split_cases(m, n, k, dt, dataflow)
    if plans is None:                   # A does not fit one IS block
        with pytest.raises(ValueError):
            sg.snake_decode_gemm(a, b, mp)
        return
    want = ref.decode_gemm_ref(a, b).float()
    for (bk, n_split), split in plans.items():
        got = sg.snake_decode_gemm(a, b, mp, split)
        torch.testing.assert_close(
            got.float(), ref.decode_gemm_split_ref(a, b, bk).float(),
            **_gemm_tol(dtype), msg=lambda e: f"bk {bk}: {e}")
        torch.testing.assert_close(got.float(), want, **_gemm_tol(dtype))


def _ragged_gemm_inputs(case):
    """bf16 a (M, K) and b (K, N) with N % 8 != 0 and K % 16 != 0:
    contiguous (rows not 16-byte aligned), a 16-byte aligned view of a
    wider B, and a B whose first element is 2 bytes past 16."""
    m, n, k = {"is": (5, 1001, 333), "os": (7, 1001, 3003)}[case[:2]]
    a, b = (torch.from_numpy(x).cuda().bfloat16()
            for x in _gemm_inputs(m, n, k))
    if case.endswith("view"):
        wide = torch.zeros(k, 1024, dtype=torch.bfloat16, device="cuda")
        wide[:, :n] = b
        b = wide[:, :n]
    elif case.endswith("offset"):
        flat = torch.zeros(k * n + 1, dtype=torch.bfloat16, device="cuda")
        flat[1:] = b.reshape(-1)
        b = flat[1:].view(k, n)
    return a, b


@pytest.mark.cuda
@pytest.mark.parametrize("case", ["is", "is_view", "is_offset", "os",
                                  "os_view", "os_offset"])
def test_cuda_gemm_ragged_bf16_matches_plain(case):
    _need_cuda()
    a, b = _ragged_gemm_inputs(case)
    (m, k), n = a.shape, b.shape[1]
    mp = sg.choose_mapping(m, n, k, a.dtype)
    assert mp.dataflow == case[:2].upper()
    want = ref.decode_gemm_ref(a, b).float()
    for split in (None, 1 if mp.dataflow == "IS" else 2, 5):
        got = sg.snake_decode_gemm(a, b, split=split)
        torch.testing.assert_close(got.float(), want, **_gemm_tol("bfloat16"))


@pytest.mark.cuda
@pytest.mark.parametrize("m,n,k,split", [
    (4, 14336, 4096, 3), (4, 4096, 14336, None), (4, 4096, 4096, None),
    (13, 257, 129, None)])
def test_cuda_gemm_is_bitwise_repeatable(m, n, k, split):
    """Two calls and two CUDA-graph replays give the same bits: the tile
    counters are back at 0 after each call and the partials are summed
    in split order whichever block arrives last."""
    _need_cuda()
    a, b = (torch.from_numpy(x).cuda().bfloat16()
            for x in _gemm_inputs(m, n, k))
    assert sg.split_k_plan(m, n, k, a.dtype, split)[1] > 1
    first = sg.snake_decode_gemm(a, b, split=split)
    assert torch.equal(sg.snake_decode_gemm(a, b, split=split), first)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        out = sg.snake_decode_gemm(a, b, split=split)
    for _ in range(2):
        out.zero_()
        graph.replay()
        torch.cuda.synchronize()
        assert torch.equal(out, first)
