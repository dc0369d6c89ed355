"""The tile skip of the bf16 K1, K2 and K3 with segment ids
(ops/flash_attention.py: ``seg_summary``, ``visited_tiles``,
``tile_shapes``, ``value_mean``, ``dead_rows_sum``), on the CPU.

The kernels visit only the tiles whose segment ranges overlap, by a summary
of the smallest and largest segment id > 0 in every 16 positions of a
batch row; K1 takes the fully masked ("dead") rows' output, mean(V), out
of its tile loop as vmean, and K3 their dv term, g / S at every key, as
gdead / S. Here, on numpy-seeded inputs:

(a) the plain summary equals a brute-force numpy summary for contiguous
    ids, interleaved and reused ids, an all-pad row and L not a multiple
    of 16;
(b) under the kernels' visit rule, at K1's (with and without the bias),
    K2's and K3's tiles and at 16 x 16, every allowed pair (l, s) -- a
    real key of the row's own segment > 0, the mask of the JAX package's
    ``reference_attention`` -- lies in a visited tile and chunk;
(c) attention over the keys of K1's visited tiles only, with the dead
    rows' out taken from value_mean and their lse set to -1e30 + log(S),
    gives the JAX package's ``reference_attention`` with segment ids (out)
    and its Pallas forward in interpret mode (lse) in f32 at 2e-5, at pad
    rows, a masked segment, interleaved ids, one segment, all-pad rows and
    a ragged L, with and without the bias;
(d) dead rows at p = 0 plus gdead / S give the dv of ``jax.grad`` of the
    JAX package's ``reference_attention`` with segment ids, in f32 at
    1e-4 relative + 1e-5 absolute (the JAX flash tests' tolerance), with
    pad rows and a segment whose keys are all masked;
(e) chip_smoke.py's bounds count the allowed pairs, the rows that see a
    key, the keys a row sees and the keys whose v K1 reads as a brute
    force counts them.

tests/test_torch_kernels_cuda.py holds the kernels themselves to the
plain versions on the card."""
import os
import runpy

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dnn_page_vectors_tpu.ops.flash_attention import (
    _flash_forward, reference_attention as jax_reference)
from dnn_page_vectors_tpu_torch.data.loader import pack_segments
from dnn_page_vectors_tpu_torch.ops import flash_attention as fa

F32 = dict(rtol=1e-4, atol=1e-5)
FWD_F32 = dict(rtol=2e-5, atol=2e-5)


def _layout(name: str, B: int, L: int, seed: int = 0) -> np.ndarray:
    """[B, L] int32 segment ids; the last batch row all pad in each:
    "packed" (pack_segments of 4 pages of random lengths: contiguous,
    ascending ids), "interleaved" (runs of ids from 0 to 4, reused along
    the row and not in order), "one_page" (one id over a prefix),
    "all_pad" (every batch row all pad)."""
    rng = np.random.default_rng(seed)
    if name == "packed":
        lens = rng.integers(1, L // 3, size=4 * B)
        enc = (np.arange(L)[None, :] < lens[:, None]).astype(np.int32)
        seg = pack_segments(enc, 4)[1]
    elif name == "interleaved":
        runs = rng.integers(0, 5, size=(B, -(-L // 5)))
        seg = np.repeat(runs, 5, axis=1)[:, :L].astype(np.int32)
    elif name == "all_pad":
        seg = np.zeros((B, L), np.int32)
    else:
        seg = np.zeros((B, L), np.int32)
        seg[:, :rng.integers(1, L)] = 7
    seg[-1] = 0
    return seg


def _brute_summary(seg: np.ndarray) -> np.ndarray:
    B, L = seg.shape
    n = -(-L // 16)
    out = np.empty((B, n, 2), np.int64)
    for b in range(B):
        for i in range(n):
            ids = [int(s) for s in seg[b, 16 * i:16 * i + 16] if s > 0]
            out[b, i] = (min(ids), max(ids)) if ids else fa.NO_SEG
    return out


LAYOUTS = [("packed", 1024), ("packed", 203), ("interleaved", 96),
           ("interleaved", 37), ("one_page", 64), ("one_page", 9)]


@pytest.mark.parametrize("name,L", LAYOUTS,
                         ids=[f"{n}_L{L}" for n, L in LAYOUTS])
def test_seg_summary_matches_brute_force(name, L):
    seg = _layout(name, 6, L, seed=L)
    got = fa.seg_summary(torch.from_numpy(seg))
    assert got.dtype == torch.int32 and got.shape == (6, -(-L // 16), 2)
    np.testing.assert_array_equal(got.numpy(), _brute_summary(seg))
    # the all-pad row holds no id anywhere
    assert (got[-1] == torch.tensor(fa.NO_SEG, dtype=torch.int32)).all()


def _allowed(seg: np.ndarray, mask: np.ndarray) -> np.ndarray:
    """[B, L, S] the pairs the JAX package's reference_attention allows:
    a real key of the row's own segment > 0."""
    return ((seg[:, :, None] == seg[:, None, :]) & (seg > 0)[:, None, :]
            & mask[:, None, :])


@pytest.mark.parametrize("name,L", LAYOUTS,
                         ids=[f"{n}_L{L}" for n, L in LAYOUTS])
@pytest.mark.parametrize("tiles", ["k1", "k1_bias", "k2", "k3", "k3_bias",
                                   "chunks"])
def test_visit_rule_covers_every_allowed_pair(name, L, tiles):
    seg = _layout(name, 6, L, seed=L)
    mask = seg > 0
    mask[0, ::3] = False          # masked keys inside live segments
    shapes = fa.tile_shapes(L, L, tiles.endswith("_bias"))
    rows, keys = (16, 16) if tiles == "chunks" else shapes[tiles[:2]]
    visited = fa.visited_tiles(fa.seg_summary(torch.from_numpy(seg)), rows,
                               keys).numpy()
    assert visited.shape == (6, -(-L // rows), -(-L // keys))
    b, l, s = np.nonzero(_allowed(seg, mask))
    assert visited[b, l // rows, s // keys].all()
    # nothing of the all-pad row is visited; the packed rows skip tiles
    assert not visited[-1].any()
    if name == "packed" and L == 1024:
        assert visited.mean() < 0.5


def _chip_smoke() -> dict:
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    return runpy.run_path(os.path.join(root, "chip_smoke.py"),
                          run_name="chip_smoke")


@pytest.mark.parametrize("name,L", LAYOUTS + [("no_seg", 40)],
                         ids=[f"{n}_L{L}" for n, L in LAYOUTS + [("no_seg",
                                                                  40)]])
def test_bound_counts_match_brute_force(name, L):
    """chip_smoke.py's bounds count the work these inputs need: the
    allowed pairs, the rows that see a key and the keys a row sees, as a
    brute force over the [B, L, S] pairs counts them (masked keys inside
    live segments, and a batch row with no real key, included)."""
    smoke = _chip_smoke()
    B, H, Dh = 6, 2, 8
    if name == "no_seg":
        seg = None
        mask = np.random.default_rng(L).random((B, L)) > 0.3
        mask[-1] = False
        allowed = np.broadcast_to(mask[:, None, :], (B, L, L))
    else:
        seg = _layout(name, B, L, seed=L)
        mask = seg > 0
        mask[0, ::3] = False
        allowed = _allowed(seg, mask)
    x = {"q": torch.zeros(B, H, L, Dh), "k": torch.zeros(B, H, L, Dh),
         "kv_mask": torch.from_numpy(mask),
         "seg": None if seg is None else torch.from_numpy(seg)}
    assert smoke["pair_count"](x) == allowed.sum()
    assert smoke["live_counts"](x) == (allowed.any(2).sum(),
                                       allowed.any(1).sum())
    # K1 reads v at every key of a batch row that holds a row that sees
    # no key (its out is the mean of V), elsewhere at the keys a row sees
    v_keys = sum(L if not allowed[b].any(1).all() else allowed[b].any(0).sum()
                 for b in range(B))
    assert smoke["v_key_count"](x) == v_keys


def _k1_with_the_skip(q, k, v, mask, seg, bias=None):
    """(out, lse) as K1 with segment ids forms them: a softmax over the
    keys of the KV tiles visited only (``visited_tiles`` at K1's tiles;
    the other keys are not looked at), the disallowed pairs there at
    -1e30; a dead row (its max is still -1e30, or it visited no tile)
    takes value_mean's mean(V) and the lse -1e30 + log(S)."""
    B, H, L, _ = q.shape
    rows, keys = fa.tile_shapes(L, L, bias is not None)["k1"]
    visited = fa.visited_tiles(fa.seg_summary(seg), rows, keys)
    seen = (visited.repeat_interleave(rows, 1)[:, :L]
            .repeat_interleave(keys, 2)[:, :, :L])           # [B, L, S]
    s = torch.einsum("bhld,bhsd->bhls", q, k) / q.shape[-1] ** 0.5
    if bias is not None:
        s = s + bias[None]
    s = torch.where(fa.allowed_pairs(mask, seg), s,
                    torch.full_like(s, fa.NEG_INF))
    s = torch.where(seen[:, None], s, torch.full_like(s, -float("inf")))
    dead = s.amax(-1) <= fa.NEG_INF                           # [B, H, L]
    live_s = torch.where(dead[..., None], torch.zeros_like(s), s)
    out = torch.einsum("bhls,bhsd->bhld", torch.softmax(live_s, -1), v)
    out = torch.where(dead[..., None], fa.value_mean(v, mask, seg)[:, :, None],
                      out)
    lse = torch.where(dead, torch.tensor(fa.NEG_INF + np.log(L),
                                         dtype=torch.float32),
                      torch.logsumexp(live_s, -1))
    return out, lse, visited


# (layout, L): pad rows, a segment whose keys are all masked, interleaved
# ids over a ragged L, one segment, all-pad batch rows, a ragged packed L
K1_LAYOUTS = [("packed", 256), ("masked_segment", 256), ("interleaved", 203),
              ("one_page", 192), ("all_pad", 128), ("packed", 203)]


@pytest.mark.parametrize("bias", [False, True], ids=["no_bias", "bias"])
@pytest.mark.parametrize("name,L", K1_LAYOUTS,
                         ids=[f"{n}_L{L}" for n, L in K1_LAYOUTS])
def test_k1_over_visited_tiles_with_dead_rows_gives_jax(name, L, bias):
    B, H, Dh = 3, 2, 16
    rng = np.random.default_rng(L)
    q, k, v = (rng.normal(size=(B, H, L, Dh)).astype(np.float32)
               for _ in range(3))
    seg = _layout("packed" if name == "masked_segment" else name, B, L,
                  seed=L)
    mask = seg > 0
    if name == "masked_segment":  # segment 2 of row 0: every key masked
        mask[0] &= seg[0] != 2
        assert (seg[0] == 2).any()
    b_arr = (rng.normal(size=(H, L, L)).astype(np.float32) if bias
             else None)
    t = lambda a: None if a is None else torch.from_numpy(a)
    out, lse, visited = _k1_with_the_skip(t(q), t(k), t(v), t(mask), t(seg),
                                          t(b_arr))
    j = lambda a: None if a is None else jnp.asarray(a)
    want = np.asarray(jax_reference(j(q), j(k), j(v), j(mask), j(b_arr),
                                    j(seg)))
    want_lse = np.asarray(_flash_forward(j(q), j(k), j(v), j(mask), j(b_arr),
                                         j(seg), 16, 16, True)[1])
    np.testing.assert_allclose(out.numpy(), want, **FWD_F32)
    dead = want_lse <= fa.MASKED_ROW_LSE
    np.testing.assert_array_equal(lse.numpy() <= fa.MASKED_ROW_LSE, dead)
    np.testing.assert_allclose(lse.numpy()[~dead], want_lse[~dead],
                               **FWD_F32)
    # the dead rows are there (the last batch row is all pad), and the
    # packed rows skip tiles
    assert dead[-1].all()
    if name in ("packed", "masked_segment") and L == 256:
        assert visited.float().mean() < 0.75


def _dv_with_dead_rows_out_of_the_loop(q, k, v, mask, g, seg, bias=None):
    """dv as K3 with segment ids forms it: p = exp(s - lse) at the allowed
    pairs of the live rows, 0 at the dead rows (lse <= MASKED_ROW_LSE),
    then gdead / S added at every key."""
    S = k.shape[2]
    _, lse = fa.reference_forward(q, k, v, mask, bias, seg)
    s = torch.einsum("bhld,bhsd->bhls", q, k) / q.shape[-1] ** 0.5
    if bias is not None:
        s = s + bias[None]
    live = (lse > fa.MASKED_ROW_LSE)[..., None]
    p = torch.where(fa.allowed_pairs(mask, seg) & live,
                    torch.exp(s - lse[..., None]), torch.zeros_like(s))
    dv = torch.einsum("bhls,bhld->bhsd", p, g)
    return dv + (fa.dead_rows_sum(g, lse) / S)[:, :, None, :]


@pytest.mark.parametrize("bias", [False, True], ids=["no_bias", "bias"])
def test_dead_rows_out_of_the_loop_give_jax_grad_dv(bias):
    B, H, L, Dh = 3, 2, 48, 16
    rng = np.random.default_rng(5)
    q, k, v, g = (rng.normal(size=(B, H, L, Dh)).astype(np.float32)
                  for _ in range(4))
    seg = _layout("packed", B, L, seed=3)
    seg[0, -6:] = 0               # pad rows inside a packed row
    mask = seg > 0
    mask[1] &= seg[1] != 2        # segment 2 of row 1: every key masked
    assert ((seg[1] == 2).any() and not mask[1][seg[1] == 2].any())
    b_arr = (rng.normal(size=(H, L, L)).astype(np.float32) if bias
             else None)

    def loss(v_):
        out = jax_reference(jnp.asarray(q), jnp.asarray(k), v_,
                            jnp.asarray(mask),
                            None if b_arr is None else jnp.asarray(b_arr),
                            jnp.asarray(seg))
        return jnp.sum(out * jnp.asarray(g))
    want = np.asarray(jax.grad(loss)(jnp.asarray(v)))
    t = lambda a: None if a is None else torch.from_numpy(a)
    got = _dv_with_dead_rows_out_of_the_loop(
        t(q), t(k), t(v), t(mask), t(g), t(seg), t(b_arr))
    # the dead rows are there: the pad rows and segment 2 of row 1
    _, lse = fa.reference_forward(t(q), t(k), t(v), t(mask), t(b_arr),
                                  t(seg))
    dead = (lse <= fa.MASKED_ROW_LSE).numpy()
    assert dead[0, :, -6:].all() and dead[1][:, seg[1] == 2].all()
    np.testing.assert_allclose(got.numpy(), want, **F32)
