"""Each mix (every file under ``traffic/``, in a cell or kept for one) is
the same for a seed, stays within its clips, and gives every seed the
same lengths in another order."""
import numpy as np
import pytest

from bench.harness import spec

MIXES = sorted(p.stem for p in (spec.BENCH_DIR / "traffic").glob("*.json"))
BIG = 2 ** 31 + 2 ** 30 + 17


def _stream(mix, seed):
    params = spec.load_json(spec.traffic_path(mix))
    return params, spec.generator(params).Stream(params, 64000, seed)


@pytest.mark.parametrize("mix", MIXES)
def test_same_seed_same_requests(mix):
    _, a = _stream(mix, BIG)
    _, b = _stream(mix, BIG)
    for (ra, pa, oa), (rb, pb, ob) in zip(a.take(300), b.take(300)):
        assert ra == rb and oa == ob and np.array_equal(pa, pb)


@pytest.mark.parametrize("mix", MIXES)
def test_within_clips(mix):
    params, s = _stream(mix, 5)
    reqs = s.take(2 * s.pool + 3)
    p = np.array([len(x[1]) for x in reqs])
    o = np.array([x[2] for x in reqs])
    assert p.min() >= params["prompt_len"]["min"]
    assert p.max() <= params["prompt_len"]["max"]
    assert o.min() >= params["output_len"]["min"]
    assert o.max() <= params["output_len"]["max"]
    assert all(x[1].max() < 64000 and x[1].min() >= 0 for x in reqs)
    assert [x[0] for x in reqs] == list(range(len(reqs)))


@pytest.mark.parametrize("mix", MIXES)
def test_seeds_reorder_the_same_work(mix):
    _, a = _stream(mix, 1)
    _, b = _stream(mix, BIG)
    ra, rb = a.take(a.pool), b.take(b.pool)
    assert sorted(len(x[1]) for x in ra) == sorted(len(x[1]) for x in rb)
    assert sorted(x[2] for x in ra) == sorted(x[2] for x in rb)
    assert [x[2] for x in ra] != [x[2] for x in rb]


@pytest.mark.parametrize("mix", MIXES)
def test_medians_as_stated(mix):
    """The median a mix states, or its mean (the clips move a mean a
    little: within 2%)."""
    params, s = _stream(mix, 3)
    reqs = s.take(s.pool)
    for key, vals in (("prompt_len", [len(x[1]) for x in reqs]),
                      ("output_len", [x[2] for x in reqs])):
        if "median" in params[key]:
            assert abs(np.median(vals) - params[key]["median"]) <= 1
        else:
            want = params[key]["mean"]
            assert abs(np.mean(vals) - want) <= 0.02 * want


@pytest.mark.parametrize("mix", MIXES)
def test_every_block_holds_each_stratum(mix):
    _, s = _stream(mix, BIG)
    n, k = s.pool, s.strata
    table = np.sort(s.output_lens).reshape(k, n // k)
    reqs = s.take(n)
    for b in range(0, n, k):
        outs = sorted(x[2] for x in reqs[b:b + k])
        # the i-th shortest of a block comes from the i-th run of quantiles
        assert all(table[i].min() <= o <= table[i].max()
                   for i, o in enumerate(outs))
    first = [x[2] for x in reqs[:256]]
    second = [x[2] for x in _stream(mix, 1)[1].take(256)]
    assert abs(np.mean(first) - np.mean(second)) < 0.02 * np.mean(first)
