"""The card-side probes (``gaussian_garments_tpu_torch/probes``) on the CPU:
their plain versions against the JAX package, the work list against
``pack_pairs``, and the wrappers' routing.

The JAX probe kernels are closures inside each script's ``_measure()`` and
cannot be imported, so the plain versions are held against what those scripts
check their kernels against (``scripts/profile_pallas_gather2.py:61,87,126``:
``table[idx]`` and ``jnp.take_along_axis``), and ``alpha_only`` against a
``jnp`` evaluation of ``nomxu_kernel``'s body
(``scripts/profile_kernel_null.py:110-130``) over the JAX ``pack_pairs``.
Tolerances:
- gathers, work list, pair counts: exact (the same integers and copies);
- ``alpha_only``: 1e-5 × max per pixel and channel (the JAX body sums each
  256-pair chunk with a vector reduction, the port serially per pixel);
- checksums: rtol 1e-6 (float64 sums of the same float32 features in another
  order).

``bin_pairs`` trims each splat's tile rect to row-exact ellipse spans as
``pack_pairs`` does at ``max_tiles_side`` ≤ 8 (``_row_spans``), so the pair
counts, the work list and the checksums are held against the side-6 pack,
the port's side. At side 9 ``pack_pairs`` packs the plain rects, which hold
extra pairs whose α is below 1/255 at every pixel of their tile:
``alpha_only`` is held against both.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gaussian_garments_tpu.ops import pallas_tiles as JPT
from gaussian_garments_tpu.ops.projection import project_gaussians as j_project
from gaussian_garments_tpu.utils.camera import make_camera as j_make_camera
from gaussian_garments_tpu_torch.ops import tiles
from gaussian_garments_tpu_torch.ops.cuda import KERNELS, SOURCES, route, source_path
from gaussian_garments_tpu_torch.ops.projection import project_gaussians
from gaussian_garments_tpu_torch.probes import composite_null, gather, grid_overhead
from gaussian_garments_tpu_torch.probes.worklist import CHUNK, build_worklist
from gaussian_garments_tpu_torch.utils.camera import make_camera

# a ragged edge row of tiles (100 = 3·32 + 4) and tiles of up to ~1,000 pairs,
# so chunks straddle tiles and tiles hold several chunks
W, H, N = 160, 100, 1500


@pytest.fixture(scope="module")
def scene():
    rng = np.random.RandomState(5)
    means = rng.randn(N, 3).astype(np.float32) * 0.3
    scales = np.exp(rng.randn(N, 3).astype(np.float32) * 0.4 - 3.2)
    rots = rng.randn(N, 4).astype(np.float32)
    opac = (1 / (1 + np.exp(-rng.randn(N)))).astype(np.float32)
    shs = rng.randn(N, 1, 3).astype(np.float32) * 0.3
    kw = dict(R=np.eye(3), T=np.array([0.0, 0, 3.0]), fx=150, fy=150, cx=W / 2, cy=H / 2,
              width=W, height=H)
    jc, tc = j_make_camera(**kw), make_camera(**kw, device="cpu")
    common = dict(image_width=W, image_height=H, tanfovx=jc.tanfovx, tanfovy=jc.tanfovy,
                  sh_degree=0)
    jp = j_project(jnp.asarray(means), jc.world_view_transform, jc.full_proj_transform,
                   jc.camera_center, scales=jnp.asarray(scales), rotations=jnp.asarray(rots),
                   shs=jnp.asarray(shs), opacities=jnp.asarray(opac), **common)
    t = torch.from_numpy
    tp = project_gaussians(t(means), tc.world_view_transform, tc.full_proj_transform,
                           tc.camera_center, scales=t(scales), rotations=t(rots), shs=t(shs),
                           opacities=t(opac), **common)
    tx, ty = tiles.tile_grid(W, H)
    packed = {side: JPT.pack_pairs(jp, tiles_x=tx, tiles_y=ty, max_tiles_side=side,
                                   pair_budget=65536, feats_packed=False) for side in (6, 9)}
    pairs = tiles.bin_pairs(tp, image_width=W, image_height=H)
    assert int(pairs.n_clipped) == int(packed[6].n_clipped) == int(packed[9].n_clipped) == 0
    assert int(packed[6].n_valid) < int(packed[9].n_valid)
    return {"packed": packed, "pairs": pairs, "tiles_x": tx, "tiles_y": ty}


# ---------------------------------------------------------------------------
# gathers
# ---------------------------------------------------------------------------

def test_flat_gathers_match_jnp():
    """Rows 3, 4C and 5 at their scripts' shapes and seeds: the plain
    version, and the CPU route of both wrappers, equal ``table[idx]``."""
    inputs = gather.make_inputs("cpu")
    for row, (rows, lanes, n, _, _) in gather.FLAT_ROWS.items():
        table, idx = inputs[row]
        assert tuple(table.shape) == (rows, lanes) and idx.numel() == n
        want = np.asarray(jnp.asarray(table.numpy()).reshape(-1)[jnp.asarray(idx.numpy())])
        np.testing.assert_array_equal(gather.gather_flat_plain(table, idx).numpy(), want)
        for variant in ("l2", "cluster"):
            np.testing.assert_array_equal(
                gather.gather_flat(table, idx, variant=variant).numpy(), want)


@pytest.mark.parametrize("row", ["4A", "4B"])
def test_axis_gathers_match_take_along_axis(row):
    axis, tshape, ishape, _ = gather.AXIS_ROWS[row]
    tab, idx = gather.make_inputs("cpu")[row]
    assert tuple(tab.shape) == tshape and tuple(idx.shape) == ishape
    want = np.asarray(jnp.take_along_axis(jnp.asarray(tab.numpy()), jnp.asarray(idx.numpy()),
                                          axis=axis))
    np.testing.assert_array_equal(gather.gather_axis_plain(tab, idx, axis).numpy(), want)
    np.testing.assert_array_equal(gather.gather_axis(tab, idx, axis).numpy(), want)


# case -> (table shape, index shape, axis): widths that are no multiple of 4,
# a single output, wide and tall outputs
AXIS_CASES = {"odd0": ((37, 131), (19, 131), 0), "odd1": ((3, 1001), (3, 257), 1),
              "one0": ((1, 1), (1, 1), 0), "one1": ((1, 1), (1, 1), 1),
              "wide0": ((5, 516), (3, 516), 0), "wide1": ((2, 600), (2, 260), 1),
              "tall0": ((600, 3), (2000, 3), 0), "tall1": ((3000, 5), (3000, 2), 1)}


@pytest.mark.parametrize("case", list(AXIS_CASES))
def test_axis_gathers_match_take_along_axis_at_any_shape(case):
    """The axis gathers equal ``jnp.take_along_axis`` at shapes other than
    the TPU rows', exactly."""
    tshape, ishape, axis = AXIS_CASES[case]
    rng = np.random.RandomState(sum(ishape))
    tab = rng.randn(*tshape).astype(np.float32)
    idx = rng.randint(0, tshape[axis], ishape).astype(np.int32)
    want = np.asarray(jnp.take_along_axis(jnp.asarray(tab), jnp.asarray(idx), axis=axis))
    got = gather.gather_axis(torch.as_tensor(tab), torch.as_tensor(idx), axis)
    np.testing.assert_array_equal(got.numpy(), want)


def test_only_the_axis_entries_carry_a_launch_floor():
    """The probe times the launch floor beside the axis gathers alone, at
    their grid of one thread an output in blocks of 256."""
    es = gather.entries("cpu")
    assert [e.row for e in es if e.floor] == ["4A", "4B"]
    for e in es:
        if e.floor:
            n = int(np.prod(gather.AXIS_ROWS[e.row][2]))
            assert f"{-(-n // gather.AXIS_THREADS)} blocks of 256" in e.shape


def test_gather_kernels_take_only_cuda_tensors():
    """The kernels' wrappers refuse CPU tensors without launching; the
    routing raises for a device that is neither."""
    table, idx = gather.make_inputs("cpu")["4A"]
    before = gather.gather_axis0_cuda.launches
    with pytest.raises(ValueError, match="cuda"):
        gather.gather_axis0_cuda(table, idx)
    with pytest.raises(ValueError, match="cuda"):
        gather.gather_flat_l2_cuda(table, idx.reshape(-1))
    assert gather.gather_axis0_cuda.launches == before
    with pytest.raises(RuntimeError, match="no kernel"):
        route(torch.device("meta"), gather.gather_flat_l2_cuda, gather.gather_flat_plain)
    with pytest.raises(ValueError, match="variant"):
        gather.gather_flat(table, idx, variant="vmem")


@pytest.fixture(scope="module")
def flat_inputs():
    return gather.make_inputs("cpu")


@pytest.mark.parametrize("cluster", gather.CLUSTER_SIZES)
@pytest.mark.parametrize("row", list(gather.FLAT_ROWS))
def test_cluster_layout_gathers_exactly(flat_inputs, row, cluster):
    """``flat_cluster``'s layout (``cluster_slices``, ``cluster_address``):
    gathering through each index's (owner, offset) equals ``table[idx]`` bit
    for bit at the TPU scripts' rows; every rank holds an equal slice."""
    table, idx = flat_inputs[row]
    slices = gather.cluster_slices(table, cluster)
    owner, offset = gather.cluster_address(idx, cluster)
    assert slices.shape[0] == cluster and slices.shape[1] % 4 == 0
    assert slices.shape[1] * cluster - table.numel() < 4 * cluster
    assert int(owner.max()) == cluster - 1 and int(offset.max()) < slices.shape[1]
    np.testing.assert_array_equal(slices[owner, offset].numpy(),
                                  gather.gather_flat_plain(table, idx).numpy())


@pytest.mark.parametrize("cluster", gather.CLUSTER_SIZES)
def test_cluster_layout_ragged_table(cluster):
    """A table whose size is no multiple of 4 × cluster (the last float4
    group and the last ranks' slices are padded), indices 0 and N − 1
    included: still ``table[idx]`` bit for bit, and the padding is zero."""
    n = 4 * cluster * 37 + 4 * 3 + 2
    rng = np.random.RandomState(cluster)
    table = torch.from_numpy(rng.randn(n).astype(np.float32))
    idx = torch.from_numpy(np.concatenate([[0, n - 1], rng.randint(0, n, 5000),
                                           np.arange(n)]).astype(np.int32))
    slices = gather.cluster_slices(table, cluster)
    owner, offset = gather.cluster_address(idx, cluster)
    np.testing.assert_array_equal(slices[owner, offset].numpy(), table[idx.long()].numpy())
    # every entry has its own place, and the rest is zero padding
    assert len(set((owner * slices.shape[1] + offset).tolist())) == n
    assert int((slices == 0).sum()) == slices.numel() - n + int((table == 0).sum())
    with pytest.raises(ValueError, match="cluster"):
        gather.cluster_slices(table, 6)


def test_gather_entries_bound_by_bytes():
    """Each entry's bound counts the table once and 8 B per index."""
    es = gather.entries("cpu")
    assert [e.row for e in es] == ["3", "3", "4C", "4C", "5", "5", "4A", "4B"]
    row3 = es[0]
    assert row3.nbytes == 1184 * 128 * 4 + 2_097_152 * 8
    ms, by = row3.bound()
    assert by == "bytes" and ms == pytest.approx(17_383_424 / 3.35e12 * 1e3)


@pytest.mark.parametrize("n", [2_097_152, 2_097_920, 4001, 4002, 4003])
@pytest.mark.parametrize("grid", [1, 7, 792])
def test_l2_partition_takes_every_index_once(n, grid):
    """``flat_l2``'s grid-stride over int4 groups (``l2_groups``, the CPU twin
    of the kernel's loop) covers every index exactly once, at the TPU rows'
    counts and at ragged counts 4k + 1 … 3, whether the grid is one block,
    a few, or as many as the card holds."""
    groups = gather.l2_groups(n, grid)
    assert groups.shape[0] == grid * gather.L2_THREADS and groups.shape[2] == gather.L2_VEC
    g = groups[groups >= 0]
    assert len(np.unique(g)) == len(g) == -(-n // 4)
    count = np.minimum(4, n - 4 * g)
    assert count.min() >= 1 and (count < 4).sum() == (n % 4 != 0)
    lane = np.arange(4)[None, :]
    pos = (4 * g[:, None] + lane)[lane < count[:, None]]
    assert np.array_equal(np.bincount(pos, minlength=n), np.ones(n, dtype=np.int64))


# ---------------------------------------------------------------------------
# the work list and the binning behind it
# ---------------------------------------------------------------------------

def test_bin_pairs_counts_match_pack_pairs(scene):
    pk, pairs = scene["packed"][6], scene["pairs"]
    nt = scene["tiles_x"] * scene["tiles_y"]
    counts = (pairs.ranges[1:] - pairs.ranges[:-1]).numpy()
    np.testing.assert_array_equal(counts, np.asarray(pk.counts)[:nt])
    np.testing.assert_array_equal(pairs.ranges[:-1].numpy(), np.asarray(pk.starts)[:nt])
    assert int(pairs.ranges[-1]) == int(pk.n_valid) > 8 * CHUNK


def test_worklist_matches_pack_pairs(scene):
    """A1's items, built from the JAX ``starts``/``counts``, equal the JAX
    ``chunk_of_item``/``tile_of_item``/``k_of_item`` over its real items."""
    pk = scene["packed"][6]
    nt = scene["tiles_x"] * scene["tiles_y"]
    starts, counts = np.asarray(pk.starts)[:nt], np.asarray(pk.counts)[:nt]
    ranges = torch.as_tensor(np.append(starts, starts[-1] + counts[-1]).astype(np.int32))
    wl = build_worklist(ranges)
    n = int(pk.n_items_total)
    assert wl.n_items == n
    # chunks straddle tiles: some chunk is read by two items
    assert len(np.unique(wl.chunk_of_item.numpy())) < n
    for got, want in ((wl.chunk_of_item, pk.chunk_of_item), (wl.tile_of_item, pk.tile_of_item),
                      (wl.k_of_item, pk.k_of_item)):
        assert got.dtype == torch.int32
        np.testing.assert_array_equal(got.numpy(), np.asarray(want)[:n])
    np.testing.assert_array_equal(wl.item4[:, :3].numpy(), np.stack(
        [wl.chunk_of_item, wl.tile_of_item, wl.k_of_item], 1))
    np.testing.assert_array_equal(wl.seg2.numpy(), np.stack([starts, counts], 1))


def _jax_item_sums(pk, n_items):
    """Per item: the sum of the 16 features of its chunk's pairs inside its
    tile's range (the JAX pair space, as ``nomxu_kernel`` masks it)."""
    f = np.asarray(pk.feats_t, np.float64)
    out = np.zeros(n_items)
    for i in range(n_items):
        c, t = int(pk.chunk_of_item[i]), int(pk.tile_of_item[i])
        s, n = int(pk.starts[t]), int(pk.counts[t])
        lo, hi = max(c * CHUNK, s), min((c + 1) * CHUNK, s + n)
        out[i] = f[:, lo:hi].sum()
    return out


def test_grid_ladder_plain_checksums(scene):
    """Variant a's per-item checksums equal the JAX pair space's per-item
    feature sums; c's are the items' valid-pair counts; every variant zeroes
    the tiles it must (d: tile 0 only) and leaves the rest unwritten."""
    pairs = scene["pairs"]
    wl = build_worklist(pairs.ranges)
    want = _jax_item_sums(scene["packed"][6], wl.n_items)
    for v in grid_overhead.VARIANTS:
        out, checksum = grid_overhead.grid_ladder(pairs, wl, v)
        assert checksum.dtype == torch.float64 and checksum.shape == (wl.n_items,)
        zeroed = sorted(set(torch.nonzero(~torch.isnan(out[:, 0, 0])).flatten().tolist()))
        if v == "d":
            assert zeroed == [0]
        else:
            assert zeroed == sorted(set(wl.tile_of_item.tolist()))
            assert bool((out[zeroed] == 0).all())
        if v == "c":
            per_item = checksum.numpy()
            assert per_item.sum() == int(pairs.ranges[-1])
            assert per_item.min() >= 1 and per_item.max() <= CHUNK
        else:
            np.testing.assert_allclose(checksum.numpy(), want, rtol=1e-6, atol=1e-9)


# per-tile pair counts whose work lists hold an even (12) and an odd (13)
# number of items; tiles with no pairs, chunks shared by two tiles, tiles of
# one to three chunks
LADDER_COUNTS = {"even": [0, 300, 0, 700, 10, 256, 1, 513],
                 "odd": [0, 300, 0, 700, 10, 256, 1, 513, 4]}


@pytest.mark.parametrize("variant", list(grid_overhead.VARIANTS))
@pytest.mark.parametrize("case", ["even", "odd", "scene"])
def test_ladder_schedule_takes_every_item_once(request, case, variant):
    """The persistent walk (``ladder_schedule``, the CPU twin of the kernel's
    loop) at one block, a few, exactly one per step and more blocks than
    steps: every item is taken exactly once, block b takes steps b, b + grid,
    ..., e pairs items (2j, 2j + 1), and the output tiles go to global memory
    as the variant says (``ladder_tile_writes``): d writes tile 0 exactly
    once, from the block that takes item 0, the first item with k == 0; the
    others write each tile that holds pairs exactly once."""
    if case == "scene":
        wl = build_worklist(request.getfixturevalue("scene")["pairs"].ranges)
    else:
        counts = LADDER_COUNTS[case]
        wl = build_worklist(torch.as_tensor(np.cumsum([0] + counts).astype(np.int32)))
        assert wl.n_items % 2 == (case == "odd")
    n, per = wl.n_items, grid_overhead.items_per_step(variant)
    steps = grid_overhead.n_steps(n, variant)
    assert int(wl.k_of_item[0]) == 0
    for grid in (1, 5, steps, steps + 3):
        sched = grid_overhead.ladder_schedule(n, grid, variant)
        assert len(sched) == min(grid, steps)
        taken = [i for blk in sched for step in blk for i in step]
        assert sorted(taken) == list(range(n))
        for b, blk in enumerate(sched):
            assert [step[0] // per for step in blk] == list(range(b, steps, len(sched)))
            for step in blk:
                j = step[0] // per
                assert step == tuple(range(per * j, min(per * j + per, n)))
        writes = grid_overhead.ladder_tile_writes(sched, wl.k_of_item, wl.tile_of_item, variant)
        if variant == "d":
            assert writes == [(0, 0)]
        else:
            tiles_written = [t for _, t in writes]
            assert sorted(tiles_written) == sorted(set(wl.tile_of_item.tolist()))
            blocks = {t: b for b, t in writes}
            for b, blk in enumerate(sched):
                for step in blk:
                    for i in step:
                        if int(wl.k_of_item[i]) == 0:
                            assert blocks[int(wl.tile_of_item[i])] == b


def test_null_plain_checksums(scene):
    """One checksum per tile: the sum of its pairs' features, equal to the
    sum of the grid ladder's per-item checksums of that tile, and the JAX
    pair space's per-tile feature sums."""
    pairs = scene["pairs"]
    out, checksum = composite_null.probe_null(pairs, image_height=H, image_width=W)
    assert all(bool((x == 0).all()) for x in (out.color, out.depth, out.alpha, out.final_logt))
    assert bool((out.last_pair == -1).all())
    wl = build_worklist(pairs.ranges)
    _, per_item = grid_overhead.grid_ladder_plain(pairs, wl, "a")
    nt = scene["tiles_x"] * scene["tiles_y"]
    per_tile = torch.zeros(nt, dtype=torch.float64).index_add_(0, wl.tile_of_item.long(),
                                                               per_item)
    np.testing.assert_allclose(checksum.numpy(), per_tile.numpy(), rtol=1e-6, atol=1e-9)
    pk = scene["packed"][6]
    f = np.asarray(pk.feats_t, np.float64)
    want = [f[:, int(pk.starts[t]):int(pk.starts[t]) + int(pk.counts[t])].sum() for t in range(nt)]
    np.testing.assert_allclose(checksum.numpy(), want, rtol=1e-6, atol=1e-9)


# ---------------------------------------------------------------------------
# alpha_only against nomxu_kernel's body
# ---------------------------------------------------------------------------

def _nomxu_jnp(pk, tiles_x, nt, n_items):
    """``nomxu_kernel``'s body (profile_kernel_null.py:110-130) per work item
    in jnp, summed over each tile's items: (T, 512, 2) of Σα and Σlog1p(−α)."""
    f_all = pk.feats_t

    def item(chunk, tile):
        start, count = pk.starts[tile], pk.counts[tile]
        ox = (jax.lax.rem(tile, tiles_x) * JPT.TILE_W).astype(jnp.float32)
        oy = (jax.lax.div(tile, tiles_x) * JPT.TILE_H).astype(jnp.float32)
        p = jax.lax.broadcasted_iota(jnp.int32, (JPT.PIX, 1), 0)
        px = ox + jax.lax.rem(p, JPT.TILE_W).astype(jnp.float32)
        py = oy + jax.lax.div(p, JPT.TILE_W).astype(jnp.float32)
        lane = jax.lax.broadcasted_iota(jnp.int32, (1, JPT.CHUNK), 1)
        f = jax.lax.dynamic_slice_in_dim(f_all, chunk * JPT.CHUNK, JPT.CHUNK, axis=1)
        pair_idx = chunk * JPT.CHUNK + lane
        valid = (pair_idx >= start) & (pair_idx < start + count)
        dx = f[0:1, :] - px
        dy = f[1:2, :] - py
        power = -0.5 * (f[2:3, :] * dx * dx + f[4:5, :] * dy * dy) - f[3:4, :] * dx * dy
        alpha = jnp.minimum(JPT.ALPHA_MAX, f[5:6, :] * jnp.exp(power))
        ok = valid & (power <= 0.0) & (alpha >= JPT.ALPHA_EPS)
        alpha = jnp.where(ok, alpha, 0.0)
        return jnp.stack([alpha.sum(1), jnp.log1p(-alpha).sum(1)], axis=1)

    per_item = jax.vmap(item)(pk.chunk_of_item[:n_items], pk.tile_of_item[:n_items])
    return jax.ops.segment_sum(per_item, pk.tile_of_item[:n_items], num_segments=nt)


@pytest.mark.parametrize("side", [6, 9])
def test_alpha_only_plain_matches_nomxu_body(scene, side):
    pk, pairs = scene["packed"][side], scene["pairs"]
    tx, ty = scene["tiles_x"], scene["tiles_y"]
    want = np.asarray(_nomxu_jnp(pk, tx, tx * ty, int(pk.n_items_total)))   # (T, 512, 2)
    want = want.reshape(ty, tx, tiles.TILE_H, tiles.TILE_W, 2).transpose(4, 0, 2, 1, 3)
    want = want.reshape(2, ty * tiles.TILE_H, tx * tiles.TILE_W)[:, :H, :W]
    got = composite_null.alpha_only(pairs, image_height=H, image_width=W)
    assert got.shape == (2, H, W)
    assert float(want[0].max()) > 1.0 and float(want[1].min()) < -1.0
    for c in range(2):
        np.testing.assert_allclose(got[c].numpy(), want[c], rtol=0,
                                   atol=1e-5 * float(np.abs(want[c]).max()))


@pytest.mark.parametrize("scene_name", ["probe", "cull"])
def test_alpha_only_warp_cull_is_bit_exact(scene, scene_name):
    """The plain ``alpha_only`` with the kernel's warp cull (a pixel skips
    a pair whose warp box, ``tiles.warp_extents``, misses its 8×4-pixel
    warp) equals the walk over every pair bit for bit: on the probe scene
    and on ``make_cull_scene`` (contours past 3σ, centres on warp corners,
    bad conics), where the cull skips pairs."""
    from gaussian_garments_tpu_torch.data.synthetic import make_cull_scene

    if scene_name == "probe":
        pairs, h, w = scene["pairs"], H, W
    else:
        h = w = 256
        pairs = tiles.bin_pairs(make_cull_scene(2000, 5, width=w, height=h, device="cpu"),
                                image_width=w, image_height=h)
        assert bool((composite_null.warp_boxes(pairs)[:, 0] < 0).any())
    full = composite_null.alpha_only_plain(pairs, image_height=h, image_width=w)
    culled = composite_null.alpha_only_plain(pairs, image_height=h, image_width=w,
                                             warp_cull=True)
    assert composite_null.warp_lanes(pairs) < tiles.PIX * int(pairs.ranges[-1])
    assert float(full[0].max()) > 1.0
    assert torch.equal(full, culled)


def test_composite_entries_bounds(scene):
    """``alpha_only``'s bound counts the terms its function sums: every
    (pair, pixel inside the image) of a tile that passes the gates, held
    against a count tile by tile; its walked count is every pair of a tile
    at each of its pixels inside the image."""
    pairs = scene["pairs"]
    null, alpha = composite_null.entries(pairs, H, W)
    counts = (pairs.ranges[1:] - pairs.ranges[:-1]).long()
    inside = composite_null.inside_pixels(pairs, H, W)
    assert int(inside.sum()) == H * W
    assert alpha.walked_evals == int((counts * inside).sum())
    want = 0
    p = torch.arange(tiles.PIX)
    for t in range(counts.numel()):
        lo, hi = int(pairs.ranges[t]), int(pairs.ranges[t + 1])
        f = pairs.feats[pairs.pair_splat[lo:hi].long()]
        px = ((t % pairs.tiles_x) * tiles.TILE_W + p % tiles.TILE_W).float()
        py = ((t // pairs.tiles_x) * tiles.TILE_H + p // tiles.TILE_W).float()
        dx, dy = f[:, 0:1] - px, f[:, 1:2] - py
        power = -0.5 * (f[:, 2:3] * dx * dx + f[:, 4:5] * dy * dy) - f[:, 3:4] * dx * dy
        al = torch.clamp(f[:, 5:6] * torch.exp(power), max=composite_null.ALPHA_MAX)
        want += int(((power <= 0) & (al >= composite_null.ALPHA_EPS) & (px < W) & (py < H)).sum())
    assert 0 < alpha.evals == want < alpha.walked_evals
    assert null.evals == 0 and null.bound()[1] == "bytes"


# ---------------------------------------------------------------------------
# the kernel registry
# ---------------------------------------------------------------------------

def test_registry_names_every_source_and_tpu_kernel():
    """Every kernel names a source that exists and exposes ``gg_cuda_error_string``
    and its entry points, and the TPU kernel it replaces."""
    import re
    from pathlib import Path

    repo = Path(__file__).resolve().parent.parent
    for source, fns in SOURCES.items():
        text = source_path(source).read_text()
        for fn in list(fns) + ["gg_cuda_error_string"]:
            assert re.search(rf"\b{fn}\(", text), (source, fn)
    for name, (source, replaces) in KERNELS.items():
        assert source in SOURCES, name
        path, line = replaces.rsplit(":", 1)
        lines = (repo / path).read_text().splitlines()
        assert "def " in lines[int(line) - 1], (name, replaces)
    wrappers = {**gather.WRAPPERS, **composite_null.WRAPPERS, **grid_overhead.WRAPPERS}
    assert set(KERNELS) == set(wrappers) | {"composite_fwd", "composite_bwd"}
    # every entry counts its launches on the wrapper named for it
    for e in gather.entries("cpu"):
        assert wrappers[e.name] is e.wrapper and e.source.endswith(f"{KERNELS[e.name][0]}.cu")
