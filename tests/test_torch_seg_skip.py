"""The tile skip of the bf16 K1, K2, K3 and K4 with segment ids
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
    K2's, K4's and K3's tiles and at 16 x 16, every allowed pair (l, s) --
    a real key of the row's own segment > 0, the mask of the JAX
    package's ``reference_attention`` -- lies in a visited tile and
    chunk;
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
    force counts them;
(f) K4 with segment ids, emulated in f32 as the kernel walks its work --
    each group of DBIAS_GROUP batch rows in order, each row over the KV
    tiles its Q tile visits only, each warp over its 16 rows and its
    16-key half of a tile, skipping chunks that miss its rows -- gives
    the dq and dbias of ``jax.grad`` of the JAX package's
    ``reference_attention`` with the bias and segment ids, in f32 at 1e-4
    relative + 1e-5 absolute, with pad tails whose Q tile visits no KV
    tile, an all-pad batch row and 11 batch rows (a group of 8 and one of
    3). dbias is held to ``jax.grad``, not to the Pallas backward, which
    is wrong at fully masked rows (every pad row of a packed row is one).

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
@pytest.mark.parametrize("tiles", ["k1", "k1_bias", "k2", "k4_bias", "k3",
                                   "k3_bias", "chunks"])
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


def _k4_with_the_skip(q, k, v, mask, g, out, lse, bias, seg):
    """(dq, dbias) in f32 as K4 with segment ids forms them: the blocks of
    a Q tile (``tile_shapes``' K4 tile) run the batch rows of each group
    of DBIAS_GROUP in order, each row over the KV tiles its Q tile visits
    (``visited_tiles``) only; in each, the warps of 16 rows take a 16-key
    half of the tile each and skip it when the 16 x 16 chunk is not
    visited; ds = p (dp - delta) at the allowed pairs of the rows that see
    a key, dq += ds k, and ds goes into the group's partial dbias, the
    partials summed in group order. Returns also the tiles visited."""
    B, H, L, Dh = q.shape
    rows, keys = fa.tile_shapes(L, L, True)["k4"]
    summary = fa.seg_summary(seg)
    visited = fa.visited_tiles(summary, rows, keys)
    chunks = fa.visited_tiles(summary, 16, 16)
    allowed = fa.allowed_pairs(mask, seg)[:, 0]               # [B, L, S]
    live = lse > fa.MASKED_ROW_LSE                            # [B, H, L]
    delta = (g * out).sum(-1)
    scale = 1.0 / Dh ** 0.5
    dq = torch.zeros(B, H, L, Dh)
    dbias = torch.zeros(H, L, L)
    for b0 in range(0, B, fa.DBIAS_GROUP):
        part = torch.zeros(H, L, L)
        for b in range(b0, min(B, b0 + fa.DBIAS_GROUP)):
            for qt, kt in visited[b].nonzero().tolist():
                for r0 in range(qt * rows, min(L, qt * rows + rows), 16):
                    for c0 in range(kt * keys, min(L, kt * keys + keys), 16):
                        if not chunks[b, r0 // 16, c0 // 16]:
                            continue     # the warp skips its half
                        r, c = slice(r0, r0 + 16), slice(c0, c0 + 16)
                        s = (torch.einsum("hld,hsd->hls", q[b, :, r],
                                          k[b, :, c]) * scale + bias[:, r, c])
                        p = torch.exp(s - lse[b, :, r, None])
                        dp = torch.einsum("hld,hsd->hls", g[b, :, r],
                                          v[b, :, c])
                        ok = allowed[b, r, c][None] & live[b, :, r, None]
                        ds = torch.where(ok, p * (dp - delta[b, :, r, None]),
                                         torch.zeros_like(p))
                        part[:, r, c] += ds
                        dq[b, :, r] += torch.einsum("hls,hsd->hld", ds,
                                                    k[b, :, c])
        dbias += part
    return dq * scale, dbias, visited


# (layout, L, B): mT5's packed page (K4's 32 x 32 tiles; pad tails that a
# whole Q tile lies in), the query tower's 16 x 16, a ragged L, and
# interleaved ids; 11 batch rows, a group of 8 and one of 3, the last all
# pad
K4_LAYOUTS = [("packed", 128, 11), ("packed", 16, 11), ("packed", 53, 11),
              ("interleaved", 96, 11)]


@pytest.mark.parametrize("name,L,B", K4_LAYOUTS,
                         ids=[f"{n}_L{L}" for n, L, _ in K4_LAYOUTS])
def test_k4_over_visited_tiles_gives_jax_grad(name, L, B):
    H, Dh = 2, 16
    rng = np.random.default_rng(L + 9)
    q, k, v, g = (rng.normal(size=(B, H, L, Dh)).astype(np.float32)
                  for _ in range(4))
    b_arr = rng.normal(size=(H, L, L)).astype(np.float32)
    seg = _layout(name, B, L, seed=L)
    mask = seg > 0
    mask[0, ::5] = False          # masked keys inside live segments
    t = torch.from_numpy
    out, lse = fa.reference_forward(t(q), t(k), t(v), t(mask), t(b_arr),
                                    t(seg))
    dq, dbias, visited = _k4_with_the_skip(t(q), t(k), t(v), t(mask), t(g),
                                           out, lse, t(b_arr), t(seg))
    rows, keys = fa.tile_shapes(L, L, True)["k4"]
    assert (rows, keys) == ((16, 16) if L <= 16 else (32, 32))

    def loss(q_, b_):
        o = jax_reference(q_, jnp.asarray(k), jnp.asarray(v),
                          jnp.asarray(mask), b_, jnp.asarray(seg))
        return jnp.sum(o * jnp.asarray(g))
    want_dq, want_db = jax.grad(loss, argnums=(0, 1))(jnp.asarray(q),
                                                      jnp.asarray(b_arr))
    np.testing.assert_allclose(dq.numpy(), np.asarray(want_dq),
                               err_msg="dq", **F32)
    np.testing.assert_allclose(dbias.numpy(), np.asarray(want_db),
                               err_msg="dbias", **F32)
    # the all-pad row visits nothing; packed rows skip tiles, and at L=128
    # some row's last Q tile (a pad tail) visits no KV tile at all
    assert not visited[-1].any()
    if name == "packed" and L >= 53:
        assert visited.float().mean() < 0.75
    if L == 128:
        assert (~visited[:-1].any(-1)).any()
