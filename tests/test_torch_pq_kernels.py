"""The plain version of the port's ADC window-scan kernel (K6,
ops/pq_kernels.py) against the JAX package's Pallas kernel run in interpret
mode and against the numpy oracle of the JAX package's own test. On a CPU
tensor the wrapper runs its plain version, so these calls are the wrapper's
CPU path.

Tolerance: each side sums the same fp32 table entries in another order, so
scores agree to rtol 1e-5 / atol 1e-4 (the reference's own tolerance); row
ids and the -inf pattern are equal.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from cuvs_rag_tpu.ops import pallas_pq
from cuvs_rag_tpu_torch.kernels import build
from cuvs_rag_tpu_torch.ops import pq as tpq
from cuvs_rag_tpu_torch.ops import pq_kernels as pk

torch.set_num_threads(1)

TOL = dict(rtol=1e-5, atol=1e-4)
CAP, WINDOW, MB = 1024, 256, 12  # 24 nibble streams
QN, PN = 5, 3


@pytest.fixture(scope="module")
def fixture():
    rng = np.random.default_rng(5)
    nibbles = rng.integers(0, 16, (CAP, 2 * MB), dtype=np.uint8)
    packed = tpq.pack_nibbles(torch.from_numpy(nibbles)).T.contiguous().numpy()
    row_ids = np.arange(CAP, dtype=np.int32)
    row_ids[::7] = -1  # tombstones and pads sprinkled in
    corr = rng.standard_normal(CAP).astype(np.float32)
    luts = rng.standard_normal((QN, PN, 2 * MB, 16)).astype(np.float32)
    offs = rng.choice(np.arange(0, CAP - WINDOW + 1, 128), (QN, PN))
    offs = offs.astype(np.int32)
    cnts = rng.integers(0, WINDOW + 1, (QN, PN)).astype(np.int32)
    cnts[0, 0] = 0        # empty list
    cnts[0, 1] = WINDOW   # full window
    cnts[1, 0] = 130      # straddles a 128-slot boundary
    coarse = rng.standard_normal((QN, PN)).astype(np.float32)
    return nibbles, packed, row_ids, corr, luts, offs, cnts, coarse


def _oracle(nibbles, row_ids, corr, luts, offs, cnts, coarse, use_corr,
            window=WINDOW):
    out_s = np.full((QN, PN, window), -np.inf, np.float32)
    out_i = np.full((QN, PN, window), -1, np.int32)
    mv = nibbles.shape[1]
    for q in range(QN):
        for p in range(PN):
            for j in range(min(window, cnts[q, p])):
                r = offs[q, p] + j
                if r >= row_ids.shape[0] or row_ids[r] < 0:
                    continue
                s = coarse[q, p] + float(
                    luts[q, p, np.arange(mv), nibbles[r]].sum())
                if use_corr:
                    s -= corr[r]
                out_s[q, p, j] = s
                out_i[q, p, j] = row_ids[r]
    return out_s, out_i


def _plain(packed, row_ids, corr, luts, offs, cnts, coarse, window=WINDOW,
           positions=False):
    t = torch.from_numpy
    before = build.launches["pq_adc_scores"]
    s, i = pk.pq_adc_scores(
        t(packed), t(row_ids), None if corr is None else t(corr), t(luts),
        t(offs), t(cnts), t(coarse), window=window, positions=positions)
    # no kernel on a CPU tensor
    assert build.launches["pq_adc_scores"] == before
    assert s.dtype == torch.float32 and i.dtype == torch.int32
    return s.numpy(), i.numpy()


@pytest.mark.parametrize("use_corr", [True, False])
def test_plain_matches_pallas_and_oracle(fixture, use_corr):
    nibbles, packed, row_ids, corr, luts, offs, cnts, coarse = fixture
    c = corr if use_corr else None
    s, i = _plain(packed, row_ids, c, luts, offs, cnts, coarse)
    ref_s, ref_i = pallas_pq.pq_adc_scores_pallas(
        jnp.asarray(packed), jnp.asarray(row_ids),
        None if c is None else jnp.asarray(c), jnp.asarray(luts),
        jnp.asarray(offs), jnp.asarray(cnts), jnp.asarray(coarse),
        window=WINDOW, interpret=True)
    want_s, want_i = _oracle(nibbles, row_ids, corr, luts, offs, cnts, coarse,
                             use_corr)
    for rs, ri in ((np.asarray(ref_s), np.asarray(ref_i)), (want_s, want_i)):
        np.testing.assert_array_equal(i, ri)
        np.testing.assert_array_equal(np.isinf(s), np.isinf(rs))
        np.testing.assert_allclose(s, rs, **TOL)
    # the cases the fixture plants
    assert np.isinf(s[0, 0]).all() and (i[0, 0] == -1).all()
    assert np.isfinite(s[0, 1]).sum() == (row_ids[offs[0, 1]:offs[0, 1]
                                                  + WINDOW] >= 0).sum()
    assert np.isinf(s[1, 0, 130:]).all() and np.isfinite(s[1, 0, :130]).any()


def test_any_window_and_offsets_past_the_layout(fixture):
    """No alignment is asked of window, cap or offsets, and a window that
    runs past the layout's end is cut there."""
    nibbles, packed, row_ids, corr, luts, offs, cnts, coarse = fixture
    window = 77
    offs = offs.copy() + 3
    offs[2, 0] = CAP - 10
    cnts = np.minimum(cnts, window)
    cnts[2, 0] = window
    s, i = _plain(packed, row_ids, corr, luts, offs, cnts, coarse, window)
    want_s, want_i = _oracle(nibbles, row_ids, corr, luts, offs, cnts, coarse,
                             True, window)
    np.testing.assert_array_equal(i, want_i)
    np.testing.assert_allclose(s, want_s, **TOL)
    assert np.isinf(s[2, 0, 10:]).all()


def test_wrapper_validates(fixture):
    _, packed, row_ids, corr, luts, offs, cnts, coarse = fixture
    t = torch.from_numpy
    args = [t(packed), t(row_ids), t(corr), t(luts), t(offs), t(cnts),
            t(coarse)]
    for pos, bad in ((0, t(packed).to(torch.int32)), (1, t(row_ids)[:-1]),
                     (2, t(corr)[:-1]), (3, t(luts)[:, :, :-1]),
                     (5, t(cnts)[:, :-1])):
        broken = list(args)
        broken[pos] = bad
        with pytest.raises(ValueError):
            pk.pq_adc_scores(*broken, window=WINDOW)
    with pytest.raises(ValueError, match="window"):
        pk.pq_adc_scores(*args, window=0)


@pytest.mark.parametrize("window", [77, 130])
@pytest.mark.parametrize("shift", [0, 1, 2, 3])
def test_ragged_windows_match_oracle(fixture, shift, window):
    """What a card kernel with wider code loads would have to get right,
    held on the plain version: window starts at every offset mod 4, an odd
    cap (stream starts are then not 4-byte aligned), a window that is no
    multiple of 4, lists of 0 rows and of more rows than the window."""
    nibbles, packed, row_ids, corr, luts, offs, cnts, coarse = fixture
    cap = CAP - 1  # odd
    offs = offs.copy() + shift
    cnts = cnts.copy()
    cnts[3, 0], cnts[3, 1] = 0, window + 50
    offs[4, 2], cnts[4, 2] = cap - 5, window  # runs past the layout
    s, i = _plain(np.ascontiguousarray(packed[:, :cap]), row_ids[:cap],
                  corr[:cap], luts, offs, cnts, coarse, window)
    want_s, want_i = _oracle(nibbles[:cap], row_ids[:cap], corr[:cap], luts,
                             offs, cnts, coarse, True, window)
    np.testing.assert_array_equal(i, want_i)
    np.testing.assert_array_equal(np.isinf(s), np.isinf(want_s))
    np.testing.assert_allclose(s, want_s, **TOL)
    assert np.isinf(s[3, 0]).all() and np.isinf(s[4, 2, 5:]).all()
    assert np.isfinite(s[3, 1]).sum() == (
        row_ids[offs[3, 1]:offs[3, 1] + window] >= 0).sum()


def _position_cases(fixture):
    """The fixtures of the tests above: the planted one, offsets shifted by
    3 with a window past the layout's end, and an odd cap with ragged
    windows and shifts (tombstones and pads at every seventh slot)."""
    nibbles, packed, row_ids, corr, luts, offs, cnts, coarse = fixture
    yield packed, row_ids, corr, luts, offs, cnts, coarse, WINDOW
    window = 77
    o = offs.copy() + 3
    o[2, 0] = CAP - 10
    c = np.minimum(cnts, window)
    c[2, 0] = window
    yield packed, row_ids, corr, luts, o, c, coarse, window
    cap = CAP - 1
    for shift in (1, 2):
        o = offs.copy() + shift
        c = cnts.copy()
        c[3, 0], c[3, 1] = 0, 130 + 50
        o[4, 2], c[4, 2] = cap - 5, 130
        yield (np.ascontiguousarray(packed[:, :cap]), row_ids[:cap],
               corr[:cap], luts, o, c, coarse, 130)


def test_plain_positions_mode(fixture):
    """positions=True: ids are the slot's layout position where the row-id
    mode gives a row id and -1 elsewhere (tombstones, pads, past the list or
    the layout); scores are the row-id mode's, bit for bit."""
    n_cases = 0
    for packed, row_ids, corr, luts, offs, cnts, coarse, window in \
            _position_cases(fixture):
        s, i = _plain(packed, row_ids, corr, luts, offs, cnts, coarse, window)
        ps, pi = _plain(packed, row_ids, corr, luts, offs, cnts, coarse,
                        window, positions=True)
        np.testing.assert_array_equal(ps, s)
        slot = offs.astype(np.int64)[:, :, None] + np.arange(window)
        np.testing.assert_array_equal(pi, np.where(i >= 0, slot, -1))
        assert (pi >= 0).any() and (pi == -1).any()
        # a live slot's position names its row
        np.testing.assert_array_equal(row_ids[pi[pi >= 0]], i[pi >= 0])
        n_cases += 1
    assert n_cases == 4


def test_positions_are_int32():
    """The kernel's positions are int32: a layout past 2^31 - 1 slots is
    refused before anything runs (checked on the shape of a tensor that is
    never read)."""
    codes = torch.empty((1, 1), dtype=torch.uint8).expand(1, 1 << 31)
    args = (codes, torch.empty((1,), dtype=torch.int32).expand(1 << 31),
            None, torch.zeros((1, 1, 2, 16)), torch.zeros((1, 1), dtype=torch.int32),
            torch.zeros((1, 1), dtype=torch.int32), torch.zeros((1, 1)))
    with pytest.raises(ValueError, match="int32"):
        pk.pq_adc_scores_plain(*args, window=8, positions=True)


@pytest.mark.parametrize("mb", [1, 5, 48, 96, pk._MAX_MB])
def test_adc_plan(mb):
    """K6's block plan: chunks of 512 window slots, four a thread (128
    threads); a block's shared memory is the (2 mb, 16) fp32 table and a
    16-byte barrier, within 227 KB up to _MAX_MB streams (the main path's
    48: 6 KB, the CLI's 96: 12 KB); past them the plan raises."""
    assert pk.adc_plan(mb) == (512, 128, 128 * mb + 16)
    assert pk.adc_plan(mb)[2] <= 227 * 1024
    if mb == pk._MAX_MB:
        assert pk.adc_plan(mb)[2] + 128 > 227 * 1024  # one stream more
        with pytest.raises(ValueError, match="byte streams"):
            pk.adc_plan(mb + 1)


def test_route_blocks(fixture):
    """adc_route_blocks counts the blocks that read codes as the kernel
    decides: windows at multiples of 4 of a cap that is a multiple of 4
    take the words route, shifted windows or an odd cap the bytes route,
    and empty lists and chunks past a list read nothing."""
    _, packed, _, _, _, offs, cnts, _ = fixture
    t = torch.from_numpy
    codes = t(packed)
    chunk = pk.adc_plan(MB)[0]
    live = np.minimum(cnts, WINDOW)
    blocks = int(((live + chunk - 1) // chunk).sum())
    assert codes.data_ptr() % 16 == 0 and CAP % 16 == 0
    for shift, route in ((0, "words"), (4, "words"), (1, "bytes"),
                         (2, "bytes")):
        o = offs + shift  # a window past the layout's end is cut there
        assert pk.adc_route_blocks(codes, t(o), t(cnts), window=WINDOW) == {
            "words": 0, "bytes": 0, route: blocks}
    odd = t(np.ascontiguousarray(packed[:, :CAP - 1]))
    assert pk.adc_route_blocks(odd, t(offs), t(cnts), window=WINDOW) == {
        "words": 0, "bytes": blocks}
