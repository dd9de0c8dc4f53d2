"""The hand-written CUDA kernels against their plain PyTorch versions, on
the card. Every test here carries the ``cuda`` marker and skips where
torch sees no CUDA device. The file imports no JAX, so on a machine with
a card and without JAX it runs alone, from the root of the repository:

    python -m pytest --noconftest -m cuda tests/test_torch_cuda.py

Tolerances: the expansion is bit-identical (every output, on workloads
that straddle its chunks of points, cut inside a chunk or at one, with no
points, with a run longer than a CTA, and with tile indices past 32768); the forward rasterizer's image
and transmittance within 1e-4 (a sequential per-pixel product against the
plain version's log-step product), rendered counts exactly; the backward
rasterizer's gradient rows, and the render's parameter gradients and
densification signal, within 1e-3 scaled by each row's or field's largest
magnitude (sequential sums against log-step sums). Both rasterizers give
bit-identical outputs from launch to launch, and hold on the adversarial
rows of ``gausplat_tpu_torch.testing.adversarial_entries`` that stress
their footprint skip (the backward's rows compared where the plain rows
are finite).

The packed (bf16-pair) entry points take the same inputs packed: the
forward within the same tolerances; the backward's packed rows decoded,
the position rows (f32 bits) within 1e-3 scaled and the bf16 rows within
1e-3 scaled plus one bf16 ulp of each element (an f32 difference of one
ulp can flip a bf16 rounding).

``Trainer.fit_scan`` replays the training step as a CUDA graph: on the
schedule of the CPU trainer tests (densify, split and clone, an opacity
reset with the point count unchanged, SH warm-up, overflow checks) with
cuDNN held deterministic, it equals ``Trainer.fit`` bit for bit (the
parameters, the Adam state, the densify accumulators and the history),
A, B and C count the same launches, and a replay reads nothing back
(``torch.cuda.set_sync_debug_mode("error")``). ``ShardedTrainer.fit_scan``
on a (1, 1) ``("data", "tiles")`` mesh over one NCCL rank captures the
sharded step with its collectives inside and holds to the same three
checks against ``ShardedTrainer.fit``.

Serving under ``torch.no_grad()`` replays one captured graph a call
(``render/views_graph.py``): ``render_views`` in both modes is bit for bit
the per-view ``render`` on every call (the warm-up, the capture, the
replays), counts A and B once a view, returns tensors that alias nothing
of the graph, reads an in-place update at its next replay, recaptures for
a scene from a setter, keeps one pool for scenes rendered in turn and
frees it with its scene; on one NCCL rank ``render_data_parallel`` and
``render_tile_sharded`` are captured with their collectives, bit for bit
their eager calls, and a replay reads nothing back.

The differentiable ``render`` replays a forward graph and its backward a
backward graph (``render/grad_graph.py``): over the warm-up, the capture,
replays, a new view, two forwards before one backward, backwards in the
reverse order and a dropped forward, every output and gradient is bit for
bit the eager render's and its backward's, with one capture, A, B and C
counted once a view, the state of a pending call moved out only where
another forward overwrites it; a new point count recaptures, a whole call
reads nothing back, and a call inside a caller's capture stays eager.

The per-call entry points replay a graph of their own: the no-grad
``render`` (entry point ``"render"``) and ``count_tile_entries`` are bit
for bit their eager forms over the warm-up, the capture and the replays,
a new view replays (one capture), a new scene recaptures, and a call
inside a caller's own capture takes the eager form; ``Trainer.fit``
(``train_step``) and ``train_step_batch`` through their graphs are bit
for bit the steps launched op by op (``_fit_eager``,
``_train_step_batch_eager``) across a densify, with the same launches;
``ShardedTrainer.fit`` on one NCCL rank likewise."""

import numpy as np
import pytest
import torch

import gausplat_tpu_torch as T
from gausplat_tpu_torch.errors import KernelError
from gausplat_tpu_torch.ops.binning import bin_gaussians, make_point_orders
from gausplat_tpu_torch.ops.expand import EXPAND, fused_point_orders
from gausplat_tpu_torch.ops.projection import Camera, project_gaussians
from gausplat_tpu_torch.ops.blend import pack_rows, unpack_rows
from gausplat_tpu_torch.ops.rasterize import (
    RASTERIZE_BACKWARD, RASTERIZE_BACKWARD_PACKED, RASTERIZE_FORWARD,
    RASTERIZE_FORWARD_PACKED, pack_point_data, rasterize_backward, rasterize_backward_torch,
    rasterize_forward, rasterize_forward_torch, tile_image,
)
from gausplat_tpu_torch.testing import assert_packed_grads_close
from gausplat_tpu_torch.testing import adversarial_entries

# By module name (pytest puts tests/ on the path), as test_rasterize.py
# imports ``oracle``: a machine may have another top-level ``tests``.
from torch_helpers import (  # noqa: F401  (cuda_device is a fixture)
    DENSIFY, EXPAND_WORKLOADS, MEDIUM, SMALL, TRAIN_SCHEDULE, cuda_device, port_view,
    scene_arrays, train_arrays,
)

pytestmark = pytest.mark.cuda

CASES = {"small": SMALL, "medium": MEDIUM}
SCALED_ATOL = 1e-3


def assert_scaled_close(got, want, what):
    scale = float(want.abs().max().clamp_min(1e-8))
    err = float((got.double() - want.double()).abs().max()) / scale
    assert err <= SCALED_ATOL, f"{what}: scaled error {err}"


@pytest.mark.parametrize("name", sorted(EXPAND_WORKLOADS))
def test_expand_kernel_matches_plain(name, cuda_device):
    arrays, capacity, tcx = EXPAND_WORKLOADS[name]()
    args = [torch.as_tensor(a, device=cuda_device) for a in arrays]
    before = EXPAND.launches
    got = fused_point_orders(*args, tile_count_x=tcx, capacity=capacity)
    want = make_point_orders(*args, tile_count_x=tcx, capacity=capacity)
    torch.cuda.synchronize()
    assert EXPAND.launches == before + 1
    for g, w in zip(got, want):
        assert g.dtype == w.dtype and torch.equal(g, w)


def _entry_data(case, device):
    c = CASES[case]
    a = scene_arrays(c["p"])
    view = port_view(c["width"], c["height"])
    tcx, tcy = -(-c["width"] // 16), -(-c["height"] // 16)
    scene = T.GaussianScene.from_numpy(**a, device=device)
    with torch.no_grad():
        proj = project_gaussians(
            scene.colors_sh, scene.positions, scene.rotations, scene.scalings,
            Camera.from_view(view, device=device), sh_degree=3, tile_count_x=tcx,
            tile_count_y=tcy, opacities=scene.opacities, tight_culling=True,
        )
        binning = bin_gaussians(
            proj.depths, proj.tile_x_max, proj.tile_x_min, proj.tile_y_min,
            proj.tile_counts, tile_count_x=tcx, tile_count_y=tcy,
            capacity=c["capacity"] or 1 << 14,
        )
        rows = pack_point_data(proj, torch.sigmoid(scene.opacities[:, 0]))
    return c, (rows, binning.point_indices, binning.tile_ranges), tcx


def _backward_args(rows, ids, ranges, tcx, width, height, seed=11):
    image, _, counts = rasterize_forward(rows, ids, ranges, tile_count_x=tcx)
    gen = torch.Generator().manual_seed(seed)
    grad = torch.randn((height, width, 3), generator=gen).to(rows.device)
    grad_tiles = tile_image(grad, tcx, -(-height // 16))
    return rows, ids, ranges, grad_tiles, torch.sum(grad_tiles * image, dim=1), counts


@pytest.mark.parametrize("case", sorted(CASES))
def test_forward_kernel_matches_plain(case, cuda_device):
    c, args, tcx = _entry_data(case, cuda_device)
    before = RASTERIZE_FORWARD.launches
    got = rasterize_forward(*args, tile_count_x=tcx)
    want = rasterize_forward_torch(*args, tile_count_x=tcx, block_size=c["block"])
    torch.cuda.synchronize()
    assert RASTERIZE_FORWARD.launches == before + 1
    torch.testing.assert_close(got[0], want[0], atol=1e-4, rtol=0)
    torch.testing.assert_close(got[1], want[1], atol=1e-4, rtol=0)
    assert torch.equal(got[2], want[2])


@pytest.mark.parametrize("case", sorted(CASES))
def test_backward_kernel_matches_plain(case, cuda_device):
    c, (rows, ids, ranges), tcx = _entry_data(case, cuda_device)
    args = _backward_args(rows, ids, ranges, tcx, c["width"], c["height"])
    before = RASTERIZE_BACKWARD.launches
    got = rasterize_backward(*args, tile_count_x=tcx)
    want = rasterize_backward_torch(*args, tile_count_x=tcx, block_size=c["block"])
    torch.cuda.synchronize()
    assert RASTERIZE_BACKWARD.launches == before + 1
    valid = int(ranges[:, 1].max())
    assert valid > 0
    for r in range(9):
        assert_scaled_close(got[r, :valid], want[r, :valid], f"row {r}")


@pytest.mark.parametrize("case", sorted(CASES))
def test_rasterize_kernels_are_deterministic(case, cuda_device):
    c, (rows, ids, ranges), tcx = _entry_data(case, cuda_device)
    first = rasterize_forward(rows, ids, ranges, tile_count_x=tcx)
    second = rasterize_forward(rows, ids, ranges, tile_count_x=tcx)
    for a, b in zip(first, second):
        assert torch.equal(a, b)
    args = _backward_args(rows, ids, ranges, tcx, c["width"], c["height"])
    valid = int(ranges[:, 1].max())
    got = [rasterize_backward(*args, tile_count_x=tcx)[:, :valid] for _ in range(2)]
    assert torch.equal(got[0], got[1])


def _adversarial(device):
    rows, ids, ranges, width, height, tcx = adversarial_entries()
    return [torch.as_tensor(a, device=device) for a in (rows, ids, ranges)], width, height, tcx


def test_forward_kernel_on_adversarial_rows(cuda_device):
    args, _, _, tcx = _adversarial(cuda_device)
    got = rasterize_forward(*args, tile_count_x=tcx)
    want = rasterize_forward_torch(*args, tile_count_x=tcx, block_size=64)
    assert torch.equal(got[2], want[2])
    torch.testing.assert_close(got[0], want[0], atol=1e-4, rtol=0)
    torch.testing.assert_close(got[1], want[1], atol=1e-4, rtol=0)
    assert int(got[2].max()) > 0


def test_backward_kernel_on_adversarial_rows(cuda_device):
    (rows, ids, ranges), width, height, tcx = _adversarial(cuda_device)
    args = _backward_args(rows, ids, ranges, tcx, width, height)
    got = rasterize_backward(*args, tile_count_x=tcx)
    want = rasterize_backward_torch(*args, tile_count_x=tcx, block_size=64)
    valid = int(ranges[:, 1].max())
    assert bool(torch.isfinite(got[:, :valid]).all())
    for r in range(9):
        finite = torch.isfinite(want[r, :valid])
        assert_scaled_close(got[r, :valid][finite], want[r, :valid][finite], f"row {r}")


@pytest.mark.parametrize("case", sorted(CASES))
def test_packed_forward_kernel_matches_plain(case, cuda_device):
    c, (rows, ids, ranges), tcx = _entry_data(case, cuda_device)
    packed = pack_rows(rows)
    before = (RASTERIZE_FORWARD.launches, RASTERIZE_FORWARD_PACKED.launches)
    got = rasterize_forward(packed, ids, ranges, tile_count_x=tcx)
    again = rasterize_forward(packed, ids, ranges, tile_count_x=tcx)
    want = rasterize_forward_torch(packed, ids, ranges, tile_count_x=tcx, block_size=c["block"])
    torch.cuda.synchronize()
    assert (RASTERIZE_FORWARD.launches, RASTERIZE_FORWARD_PACKED.launches) == (
        before[0], before[1] + 2)
    torch.testing.assert_close(got[0], want[0], atol=1e-4, rtol=0)
    torch.testing.assert_close(got[1], want[1], atol=1e-4, rtol=0)
    assert torch.equal(got[2], want[2])
    assert all(torch.equal(a, b) for a, b in zip(got, again))
    # The same blend as the f32 kernel on the decoded rows.
    decoded = rasterize_forward(unpack_rows(packed), ids, ranges, tile_count_x=tcx)
    assert all(torch.equal(a, b) for a, b in zip(got, decoded))


@pytest.mark.parametrize("case", sorted(CASES))
def test_packed_backward_kernel_matches_plain(case, cuda_device):
    c, (rows, ids, ranges), tcx = _entry_data(case, cuda_device)
    args = _backward_args(pack_rows(rows), ids, ranges, tcx, c["width"], c["height"])
    before = RASTERIZE_BACKWARD_PACKED.launches
    got = rasterize_backward(*args, tile_count_x=tcx)
    again = rasterize_backward(*args, tile_count_x=tcx)
    want = rasterize_backward_torch(*args, tile_count_x=tcx, block_size=c["block"])
    torch.cuda.synchronize()
    assert RASTERIZE_BACKWARD_PACKED.launches == before + 2
    assert got.dtype == torch.int32 and got.shape == (6, ids.shape[0])
    valid = int(ranges[:, 1].max())
    assert torch.equal(got[:, :valid], again[:, :valid])
    assert_packed_grads_close(got[:, :valid], want[:, :valid], SCALED_ATOL)
    # The f32 kernel on the decoded rows gives the same sums, then packed.
    f32 = rasterize_backward(unpack_rows(args[0]), *args[1:], tile_count_x=tcx)
    assert torch.equal(got[:, :valid], pack_rows(f32[:, :valid]))


def test_packed_kernels_on_adversarial_rows(cuda_device):
    (rows, ids, ranges), width, height, tcx = _adversarial(cuda_device)
    packed = pack_rows(rows)
    got = rasterize_forward(packed, ids, ranges, tile_count_x=tcx)
    want = rasterize_forward_torch(packed, ids, ranges, tile_count_x=tcx, block_size=64)
    assert torch.equal(got[2], want[2])
    torch.testing.assert_close(got[0], want[0], atol=1e-4, rtol=0)
    args = _backward_args(packed, ids, ranges, tcx, width, height)
    valid = int(ranges[:, 1].max())
    got = unpack_rows(rasterize_backward(*args, tile_count_x=tcx)[:, :valid])
    want = unpack_rows(rasterize_backward_torch(*args, tile_count_x=tcx, block_size=64)[:, :valid])
    assert bool(torch.isfinite(got).all())
    finite = torch.isfinite(want).all(dim=0)
    assert_packed_grads_close(pack_rows(got[:, finite]), pack_rows(want[:, finite]), SCALED_ATOL)


def test_rasterize_kernels_launch_info(cuda_device):
    for kernel in (RASTERIZE_FORWARD, RASTERIZE_BACKWARD, RASTERIZE_FORWARD_PACKED,
                   RASTERIZE_BACKWARD_PACKED):
        info = kernel.launch_info()
        assert 0 < info["registers"] <= 64 and 0 < info["shared_bytes"] < 48 * 1024, info
        assert info["blocks_per_sm"] >= 4, info


def test_render_grads_through_kernels_match_plain_path(cuda_device):
    c = MEDIUM
    view = port_view(c["width"], c["height"], position=(0.3, -0.2, -4.0))
    weight = torch.randn((c["height"], c["width"], 3),
                         generator=torch.Generator().manual_seed(5)).to(cuda_device)
    grads = {}
    for backend in ("cuda", "torch"):
        scene = T.GaussianScene.from_numpy(**scene_arrays(c["p"]), device=cuda_device)
        ref = torch.zeros(c["p"], device=cuda_device, requires_grad=True)
        out = T.render(scene, view, T.RenderOptions(backend=backend), ref)
        torch.sum(out.colors_rgb_2d * weight).backward()
        grads[backend] = {name: p.grad for name, p in scene.named_parameters()}
        grads[backend]["norm"] = ref.grad
    for name, want in grads["torch"].items():
        assert bool(torch.isfinite(grads["cuda"][name]).all()), name
        assert_scaled_close(grads["cuda"][name], want, name)


def test_bf16_render_and_grads_through_kernels_match_plain_path(cuda_device):
    c = MEDIUM
    view = port_view(c["width"], c["height"], position=(0.3, -0.2, -4.0))
    weight = torch.randn((c["height"], c["width"], 3),
                         generator=torch.Generator().manual_seed(5)).to(cuda_device)
    outs, grads = {}, {}
    before = (RASTERIZE_FORWARD_PACKED.launches, RASTERIZE_BACKWARD_PACKED.launches)
    for backend in ("cuda", "torch"):
        scene = T.GaussianScene.from_numpy(**scene_arrays(c["p"]), device=cuda_device)
        ref = torch.zeros(c["p"], device=cuda_device, requires_grad=True)
        outs[backend] = T.render(scene, view, T.RenderOptions(backend=backend,
                                                              entry_dtype="bf16"), ref)
        torch.sum(outs[backend].colors_rgb_2d * weight).backward()
        grads[backend] = {name: p.grad for name, p in scene.named_parameters()}
        grads[backend]["norm"] = ref.grad
    assert (RASTERIZE_FORWARD_PACKED.launches, RASTERIZE_BACKWARD_PACKED.launches) == (
        before[0] + 1, before[1] + 1)
    got, want = outs["cuda"], outs["torch"]
    torch.testing.assert_close(got.colors_rgb_2d, want.colors_rgb_2d, atol=1e-4, rtol=0)
    assert torch.equal(got.point_rendered_counts, want.point_rendered_counts)
    for name, value in grads["torch"].items():
        assert bool(torch.isfinite(grads["cuda"][name]).all()), name
        assert_scaled_close(grads["cuda"][name], value, name)


def test_render_through_kernels_matches_plain_path(cuda_device):
    c = MEDIUM
    scene = T.GaussianScene.from_numpy(**scene_arrays(c["p"]), device=cuda_device)
    view = port_view(c["width"], c["height"], position=(0.3, -0.2, -4.0))
    launches = (EXPAND.launches, RASTERIZE_FORWARD.launches)
    got = T.render(scene, view, T.RenderOptions(backend="cuda"))
    want = T.render(scene, view, T.RenderOptions(backend="torch"))
    assert (EXPAND.launches, RASTERIZE_FORWARD.launches) == (launches[0] + 1, launches[1] + 1)
    torch.testing.assert_close(got.colors_rgb_2d, want.colors_rgb_2d, atol=1e-4, rtol=0)
    torch.testing.assert_close(got.transmittances, want.transmittances, atol=1e-4, rtol=0)
    for field in ("radii", "tile_point_total", "point_rendered_counts"):
        assert torch.equal(getattr(got, field), getattr(want, field)), field


def test_kernel_wrappers_reject_bad_arguments(cuda_device):
    _, (rows, ids, ranges), tcx = _entry_data("small", cuda_device)
    with pytest.raises(TypeError):
        rasterize_forward(rows.double(), ids, ranges, tile_count_x=tcx)
    with pytest.raises(ValueError):
        rasterize_forward(rows, ids.cpu(), ranges, tile_count_x=tcx)
    with pytest.raises(ValueError):
        rasterize_forward(rows[:8], ids, ranges, tile_count_x=tcx)
    with pytest.raises(ValueError):
        rasterize_forward(pack_rows(rows)[:5], ids, ranges, tile_count_x=tcx)
    with pytest.raises(ValueError):  # an f32 build for packed rows
        rasterize_forward(pack_rows(rows), ids, ranges, tile_count_x=tcx,
                          kernel=RASTERIZE_FORWARD)
    depths = torch.ones(4, device=cuda_device)
    ints = torch.zeros(4, dtype=torch.int64, device=cuda_device)
    with pytest.raises(TypeError):
        fused_point_orders(depths, ints, ints, ints, ints, tile_count_x=4, capacity=64)
    assert issubclass(KernelError, Exception)
    assert np.isfinite(rows.cpu().numpy()).all()


# --- the user-facing tools on the card ------------------------------------------------

def test_native_codec_matches_numpy_on_the_card(cuda_device):
    from gausplat_tpu_torch.utils import native

    from gausplat_tpu_torch.scene import ply

    assert native.available()
    scene = T.GaussianScene.from_numpy(**scene_arrays(100_000, seed=8), device=cuda_device)
    arrays = [getattr(scene, f).detach().cpu().numpy() for f in ply.FIELDS]
    payload = native.encode_payload(*arrays)
    assert payload == ply.encode_payload_numpy(*arrays)
    for decode in (native.decode_payload, ply.decode_payload_numpy):
        for got, want in zip(decode(payload, 100_000), arrays):
            np.testing.assert_array_equal(got.view(np.int32), want.view(np.int32))
    blob = T.encode_polygon(scene)
    assert blob.endswith(payload)
    back = T.decode_polygon(blob, device=cuda_device)
    for f in ply.FIELDS:
        assert torch.equal(getattr(back, f).view(torch.int32),
                           getattr(scene, f).detach().view(torch.int32)), f


def test_render_ply_end_to_end_on_the_card(cuda_device, tmp_path):
    from gausplat_tpu_torch.scripts import render_ply as RP

    scene = T.GaussianScene.from_numpy(**scene_arrays(MEDIUM["p"]), device=cuda_device)
    ply, png = tmp_path / "scene.3dgs.ply", tmp_path / "out.png"
    ply.write_bytes(T.encode_polygon(scene))
    launches = (EXPAND.launches, RASTERIZE_FORWARD.launches)
    RP.main([str(ply), str(png), "--width", "320", "--height", "200", "--azimuth", "0.4",
             "--device", "cuda"])
    assert (EXPAND.launches, RASTERIZE_FORWARD.launches) == (launches[0] + 1, launches[1] + 1)
    view = RP.orbit_view(scene.positions.detach().cpu().numpy(), 320, 200, azimuth=0.4)
    with torch.no_grad():
        want = RP.to_u8(T.render(scene, view, T.RenderOptions()).colors_rgb_2d)
    got = RP.decode_png(png.read_bytes())
    assert got.shape == (200, 320, 3) and want.std() > 1
    np.testing.assert_array_equal(got, want)


def test_fit_toy_scene_launches_every_kernel(cuda_device):
    from gausplat_tpu_torch.examples.fit_toy_scene import fit_toy_scene

    kernels = (EXPAND, RASTERIZE_FORWARD, RASTERIZE_BACKWARD)
    before = [k.launches for k in kernels]
    result = fit_toy_scene(20, device=cuda_device, log=lambda line: None)
    assert all(k.launches >= b + 20 for k, b in zip(kernels, before))
    assert np.isfinite(result["losses"]).all() and len(result["losses"]) == 20
    assert result["round_trip_identical"]


@pytest.mark.parametrize("slab", [3, 0])
def test_pad_slab_kernels_match_plain(slab, cuda_device):
    """A, B and C on a slab of ``mesh_scale``'s step at 8 ranks (the camera
    shifted by its first row, as the sharded step renders it): slab 3 (rows
    96-127 of an 80-row frame) lies wholly in the padding and bins no
    entry; slab 0 (rows 0-31) is live, with entries for C to write. B bit
    for bit, A's counts exact and its image within 1e-4, C's rows within
    1e-3 scaled."""
    from gausplat_tpu_torch.parallel.render import _shard_capacity, slab_rows
    from gausplat_tpu_torch.render.pipeline import _capacity
    from gausplat_tpu_torch.scripts import mesh_scale as MS

    n = 8
    height, options = MS.parity_height(n), MS.PARITY_OPTIONS
    h_local, _ = slab_rows(height, n // 2)
    y0 = slab * h_local
    assert h_local == 32 and height == 80 and (y0 >= height) == (slab == 3)
    scene = MS.parity_scene(cuda_device)
    view = MS.parity_views(height)[0]
    tcx, tcy = view.image_width // 16, h_local // 16
    capacity = _shard_capacity(_capacity(scene.point_count, options), n // 2, options.block_size)
    camera = Camera.from_view(view, device=cuda_device)
    camera.pos2d_shift = torch.tensor([0.0, float(y0)], device=cuda_device)
    with torch.no_grad():
        proj = project_gaussians(
            scene.colors_sh, scene.positions, scene.rotations, scene.scalings, camera,
            sh_degree=3, tile_count_x=tcx, tile_count_y=tcy, opacities=scene.opacities,
            tight_culling=True)
        b_args = (proj.depths, proj.tile_x_max, proj.tile_x_min, proj.tile_y_min,
                  proj.tile_counts)
        binning = bin_gaussians(*b_args, tile_count_x=tcx, tile_count_y=tcy, capacity=capacity)
        rows = pack_point_data(proj, torch.sigmoid(scene.opacities[:, 0]))
    before = [k.launches for k in (EXPAND, RASTERIZE_FORWARD, RASTERIZE_BACKWARD)]
    got = fused_point_orders(*b_args, tile_count_x=tcx, capacity=capacity)
    want = make_point_orders(*b_args, tile_count_x=tcx, capacity=capacity)
    for g, w in zip(got, want):
        assert torch.equal(g, w)
    args = (rows, binning.point_indices, binning.tile_ranges)
    a_got = rasterize_forward(*args, tile_count_x=tcx)
    a_want = rasterize_forward_torch(*args, tile_count_x=tcx, block_size=options.block_size)
    torch.testing.assert_close(a_got[0], a_want[0], atol=1e-4, rtol=0)
    assert torch.equal(a_got[2], a_want[2])
    c_args = _backward_args(*args, tcx, view.image_width, h_local)
    c_got = rasterize_backward(*c_args, tile_count_x=tcx)
    c_want = rasterize_backward_torch(*c_args, tile_count_x=tcx, block_size=options.block_size)
    torch.cuda.synchronize()
    valid = int(binning.tile_ranges[:, 1].max())
    assert (valid == 0) == (slab == 3)
    for r in range(9 if valid else 0):  # the padded slab: no entry, no row to compare
        assert_scaled_close(c_got[r, :valid], c_want[r, :valid], f"row {r}")
    after = [k.launches for k in (EXPAND, RASTERIZE_FORWARD, RASTERIZE_BACKWARD)]
    assert [a - b for a, b in zip(after, before)] == [1, 2, 1]  # A again in C's inputs


def test_train_convergence_launches_every_kernel(cuda_device):
    from gausplat_tpu_torch.scripts.train_convergence import train_convergence

    kernels = (EXPAND, RASTERIZE_FORWARD, RASTERIZE_BACKWARD)
    before = [k.launches for k in kernels]
    result = train_convergence(20, device=cuda_device, log=lambda line: None)
    assert all(k.launches >= b + 20 for k, b in zip(kernels, before))
    assert all(result["launches"][k.entry] >= 20 for k in kernels)  # the fit's alone
    assert np.isfinite([h["loss"] for h in result["history"]]).all()
    assert len(result["history"]) == 20 and len(result["curve"]) == 5


def _fit_scan_setup(device):
    from gausplat_tpu_torch import train as TT

    size = 48
    pairs = [port_view(size, size), port_view(size, size, position=(0.3, 0.1, -4.0))]
    options = T.RenderOptions(tile_entry_capacity=2048, block_size=64)
    target = T.GaussianScene.from_numpy(**train_arrays(25, 5), device=device)
    with torch.no_grad():
        targets = [T.render(target, v, options).colors_rgb_2d for v in pairs]
    config = TT.TrainConfig(render=options, densify=TT.DensifyConfig(**DENSIFY),
                            **TRAIN_SCHEDULE)

    def trainer():
        scene = T.GaussianScene.from_numpy(**train_arrays(25, 9), device=device)
        return TT.Trainer(scene, size, size, config)

    return trainer, pairs, targets


@pytest.fixture
def deterministic_cudnn():
    before = torch.backends.cudnn.deterministic
    torch.backends.cudnn.deterministic = True
    yield
    torch.backends.cudnn.deterministic = before


def _counted(fn):
    kernels = (EXPAND, RASTERIZE_FORWARD, RASTERIZE_BACKWARD)
    before = [k.launches for k in kernels]
    result = fn()
    torch.cuda.synchronize()
    return result, [k.launches - b for k, b in zip(kernels, before)]


def test_fit_scan_matches_fit(cuda_device, deterministic_cudnn):
    make, pairs, targets = _fit_scan_setup(cuda_device)
    eager, scan = make(), make()
    want, eager_launches = _counted(lambda: eager.fit(pairs, targets, 13))
    got, scan_launches = _counted(lambda: scan.fit_scan(pairs, targets, 13, max_chunk=4))
    assert scan._graph.captures >= 2 and scan._graph.replays >= 5
    assert scan_launches == eager_launches == [13, 13, 13]
    assert scan.scene.point_count == eager.scene.point_count > 25
    for key in ("loss", "psnr", "tile_point_total"):
        assert [h[key] for h in got] == [h[key] for h in want], key
    for f in ("colors_sh", "opacities", "positions", "rotations", "scalings"):
        assert torch.equal(getattr(scan.scene, f), getattr(eager.scene, f)), f
        for a, b in zip(scan._opt_state["adam"][f], eager._opt_state["adam"][f]):
            assert torch.equal(a, b), f
    for k, v in eager._densify_acc.items():
        assert torch.equal(scan._densify_acc[k], v), k


def test_fit_scan_replay_reads_nothing_back(cuda_device):
    make, pairs, targets = _fit_scan_setup(cuda_device)
    trainer = make()
    trainer.fit_scan(pairs, targets, 3)
    graph = trainer._graph
    assert graph.graph is not None
    positions = trainer.scene.positions.detach().clone()
    _, launches = _counted(lambda: _replay_strict(graph))
    assert launches == [1, 1, 1]
    assert not torch.equal(trainer.scene.positions.detach(), positions)


def _replay_strict(graph):
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        graph.replay()
    finally:
        torch.cuda.set_sync_debug_mode("default")


@pytest.fixture
def nccl_mesh(cuda_device):
    """A (1, 1) ("data", "tiles") mesh over a default group of one NCCL
    rank on ``cuda_device``."""
    import torch.distributed as dist

    from gausplat_tpu_torch.parallel import make_mesh
    from gausplat_tpu_torch.testing import free_port

    torch.cuda.set_device(cuda_device)
    dist.init_process_group("nccl", init_method=f"tcp://localhost:{free_port()}",
                            world_size=1, rank=0)
    try:
        yield make_mesh((1, 1), ("data", "tiles"))
    finally:
        dist.destroy_process_group()


def _sharded_fit_scan_setup(device, mesh):
    from gausplat_tpu_torch.parallel import stack_cameras
    from gausplat_tpu_torch.parallel.train_step import ShardedTrainer

    make, pairs, targets = _fit_scan_setup(device)

    def trainer():
        t = make()
        return ShardedTrainer(t.scene, mesh, t.image_width, t.image_height, t.config)

    return trainer, stack_cameras(pairs, device=device), torch.stack(targets)


def test_sharded_fit_scan_matches_fit_on_nccl(nccl_mesh, cuda_device, deterministic_cudnn):
    make, cameras, targets = _sharded_fit_scan_setup(cuda_device, nccl_mesh)
    eager, scan = make(), make()
    want, eager_launches = _counted(lambda: eager.fit(cameras, targets, 13))
    got, scan_launches = _counted(lambda: scan.fit_scan(cameras, targets, 13, max_chunk=4))
    assert nccl_mesh.backend == "nccl"
    assert scan._graph.captures >= 2 and scan._graph.replays >= 5
    assert scan_launches == eager_launches == [26, 26, 26]  # both views, every step
    assert scan.scene.point_count == eager.scene.point_count > 25
    for key in ("loss", "tile_point_total"):
        assert [h[key] for h in got] == [h[key] for h in want], key
    for f in ("colors_sh", "opacities", "positions", "rotations", "scalings"):
        assert torch.equal(getattr(scan.scene, f), getattr(eager.scene, f)), f
        for a, b in zip(scan._opt_state["adam"][f], eager._opt_state["adam"][f]):
            assert torch.equal(a, b), f
    for k, v in eager._densify_acc.items():
        assert torch.equal(scan._densify_acc[k], v), k


def test_sharded_fit_scan_replay_reads_nothing_back_on_nccl(nccl_mesh, cuda_device):
    make, cameras, targets = _sharded_fit_scan_setup(cuda_device, nccl_mesh)
    trainer = make()
    trainer.fit_scan(cameras, targets, 3)
    graph = trainer._graph
    assert graph.graph is not None and graph.captures == 1 and graph.replays == 2
    positions = trainer.scene.positions.detach().clone()
    _, launches = _counted(lambda: _replay_strict(graph))
    assert launches == [2, 2, 2]
    assert not torch.equal(trainer.scene.positions.detach(), positions)


def _serving_setup(device, seed=5):
    """A small scene on the card and two views of it at 48 x 32."""
    scene = T.GaussianScene.from_numpy(**scene_arrays(SMALL["p"], seed), device=device)
    views = [port_view(48, 32), port_view(48, 32, position=(0.3, 0.1, -4.0))]
    return scene, views, T.RenderOptions(tile_entry_capacity=2048, block_size=64)


def _singles(scene, views, options):
    from gausplat_tpu_torch.render.pipeline import _render_eager

    with torch.no_grad():
        outs = [_render_eager(scene, v, options) for v in views]
    return [torch.stack([getattr(o, f) for o in outs]) for f in T.RenderOutput._fields]


@pytest.mark.parametrize("mode", ["vmap", "map"])
def test_render_views_graph_matches_render(mode, cuda_device):
    from gausplat_tpu_torch.render.views_graph import views_graph

    scene, views, options = _serving_setup(cuda_device)
    graph = views_graph("render_views", cuda_device)
    graph.release()
    want = _singles(scene, views, options)
    calls = []
    with torch.no_grad():
        for _ in range(4):  # the warm-up, the capture, two replays
            out, launches = _counted(lambda: T.render_views(scene, views, options, mode=mode))
            calls.append((out, launches, graph.graph.captures, graph.graph.replays))
    assert [c[2:] for c in calls] == [(0, 0), (1, 1), (1, 2), (1, 3)]
    for out, launches, _, _ in calls:
        assert launches == [2, 2, 0]  # B and A once a view, replays counted
        for field, got, single in zip(out._fields, out, want):
            assert torch.equal(got, single), field
        assert all(t.data_ptr() != s.data_ptr() for t, s in zip(out, graph.outputs))
    # An earlier call's outputs are its own: a replay for other views leaves them.
    kept = [t.clone() for t in calls[3][0]]
    with torch.no_grad():
        other = T.render_views(scene, views[::-1], options, mode=mode)
    assert graph.graph.replays == 4 and torch.equal(other.colors_rgb_2d[0], want[0][1])
    assert all(torch.equal(a, b) for a, b in zip(calls[3][0], kept))


def test_render_views_graph_sees_in_place_updates_and_recaptures_for_setters(cuda_device):
    from gausplat_tpu_torch.render.views_graph import views_graph

    scene, views, options = _serving_setup(cuda_device)
    graph = views_graph("render_views", cuda_device)
    graph.release()
    with torch.no_grad():
        for _ in range(2):
            T.render_views(scene, views, options)
        scene.positions.add_(0.05)
        moved = T.render_views(scene, views, options)
        assert (graph.graph.captures, graph.graph.replays) == (1, 2)
        for field, got, single in zip(moved._fields, moved, _singles(scene, views, options)):
            assert torch.equal(got, single), field
        _replay_strict(graph.graph)  # a replay reads nothing back
        moved_scene = scene.set_opacities(scene.get_opacities() * 0.5)
        first = T.render_views(moved_scene, views, options)  # a miss: the warm-up
        assert (graph.graph.captures, graph.graph.replays) == (1, 3)
        second = T.render_views(moved_scene, views, options)
        assert (graph.graph.captures, graph.graph.replays) == (2, 4)
    want = _singles(moved_scene, views, options)
    for out in (first, second):
        assert all(torch.equal(got, w) for got, w in zip(out, want))


def test_render_views_graph_keeps_one_pool(cuda_device):
    import gc

    from gausplat_tpu_torch.render.views_graph import views_graph

    graph = views_graph("render_views", cuda_device)
    graph.release()
    scenes = [_serving_setup(cuda_device, seed)[0] for seed in (5, 6, 7)]
    _, views, options = _serving_setup(cuda_device)

    def reserved():
        gc.collect()
        torch.cuda.synchronize()
        torch.cuda.empty_cache()
        return torch.cuda.memory_reserved(cuda_device)

    base = reserved()
    after = []
    with torch.no_grad():
        for scene in scenes:  # three scenes in turn, each warmed up and captured
            for _ in range(2):
                T.render_views(scene, views, options, mode="vmap")
            after.append(reserved())
    assert graph.graph.captures == 3
    assert after[2] - base < 2 * (after[0] - base), (base, after)
    del scenes, scene
    gc.collect()
    assert graph.graph.graph is None and graph.rows is None  # freed with its scene


def test_nccl_serving_is_captured_and_matches_eager(nccl_mesh, cuda_device):
    from gausplat_tpu_torch.parallel import (
        render_data_parallel, render_tile_sharded, stack_cameras,
    )
    from gausplat_tpu_torch.render.views_graph import views_graph

    scene, views, options = _serving_setup(cuda_device)
    cameras = stack_cameras(views, device=cuda_device)
    cases = {
        "parallel.render_data_parallel": lambda: render_data_parallel(
            scene, cameras, 48, 32, nccl_mesh, "data", options),
        "parallel.render_tile_sharded": lambda: render_tile_sharded(
            scene, views[1], nccl_mesh, "tiles", options),
    }
    for name, call in cases.items():
        graph = views_graph(name, cuda_device)
        graph.release()
        want = call()  # grad needed: the eager call
        assert want.colors_rgb_2d.requires_grad
        with torch.no_grad():
            outs = [call() for _ in range(3)]
        assert (graph.graph.captures, graph.graph.replays) == (1, 2), name
        for out in outs:
            for field, got, w in zip(out._fields, out, want):
                assert torch.equal(got, w.detach()), (name, field)
        _, launches = _counted(lambda: _replay_strict(graph.graph))
        assert launches == ([2, 2, 0] if "data" in name else [1, 1, 0]), name
        graph.release()  # before the fixture's process group goes


def _entry_graph(name, device):
    from gausplat_tpu_torch.render.views_graph import views_graph

    graph = views_graph(name, device)
    graph.release()
    return graph


def test_render_graph_matches_the_eager_render(cuda_device):
    from gausplat_tpu_torch.render.pipeline import _render_eager

    scene, views, options = _serving_setup(cuda_device)
    graph = _entry_graph("render", cuda_device)
    ref = torch.linspace(0.5, 2.0, scene.point_count, device=cuda_device)  # read by no output
    calls = []
    with torch.no_grad():
        # The warm-up, the capture, a replay, then a new view: a replay.
        for view in (views[0], views[0], views[0], views[1]):
            out, launches = _counted(lambda: T.render(scene, view, options, ref))
            want = _render_eager(scene, view, options)
            for field, got, w in zip(out._fields, out, want):
                assert got.shape == w.shape and torch.equal(got, w), field
            assert all(t.data_ptr() != s.data_ptr() for t, s in zip(out, graph.outputs))
            calls.append((launches, graph.graph.captures, graph.graph.replays))
    assert calls == [([1, 1, 0], 0, 0), ([1, 1, 0], 1, 1), ([1, 1, 0], 1, 2),
                     ([1, 1, 0], 1, 3)]
    _, launches = _counted(lambda: _replay_strict(graph.graph))  # reads nothing back
    assert launches == [1, 1, 0]
    # A new scene misses: the warm-up, then the capture.
    other = T.GaussianScene.from_numpy(**scene_arrays(SMALL["p"], 6), device=cuda_device)
    with torch.no_grad():
        for _ in range(2):
            out = T.render(other, views[1], options)
    assert (graph.graph.captures, graph.graph.replays) == (2, 5)
    want = _render_eager(other, views[1], options)
    assert all(torch.equal(a, b.detach()) for a, b in zip(out, want))
    # Grad needed: the eager, differentiable render.
    out = T.render(other, views[1], options)
    assert out.colors_rgb_2d.requires_grad and graph.graph.replays == 5


def test_entry_points_inside_a_capture_stay_eager(cuda_device, monkeypatch):
    from gausplat_tpu_torch.render import pipeline

    scene, views, options = _serving_setup(cuda_device)
    graph = _entry_graph("render", cuda_device)
    taken = []

    def eager(*args, **kwargs):  # records the call; a host copy could not be captured
        taken.append(args[1])
        return torch.zeros((), device=cuda_device).add_(1.0)

    monkeypatch.setattr(pipeline, "_render_eager", eager)
    caller = torch.cuda.CUDAGraph()
    side = torch.cuda.Stream(cuda_device)
    side.wait_stream(torch.cuda.current_stream(cuda_device))
    with torch.no_grad(), torch.cuda.stream(side):
        eager(None, None)
    torch.cuda.current_stream(cuda_device).wait_stream(side)
    with torch.no_grad(), torch.cuda.graph(caller):
        got = T.render(scene, views[0], options)
    caller.replay()
    torch.cuda.synchronize()
    assert taken[1:] == [views[0]] and float(got) == 1.0
    assert (graph.graph.captures, graph.graph.replays, graph.rows) == (0, 0, None)


def test_count_tile_entries_graph_matches_eager(cuda_device):
    from gausplat_tpu_torch.render.pipeline import _count_tile_entries_eager

    scene, views, options = _serving_setup(cuda_device)
    graph = _entry_graph("count_tile_entries", cuda_device)
    got = [T.count_tile_entries(scene, v, options) for v in (views[0], views[0], views[1])]
    want = [_count_tile_entries_eager(scene, v, options) for v in (views[0], views[0], views[1])]
    assert got == want and min(got) > 0
    assert (graph.graph.captures, graph.graph.replays) == (1, 2)
    # calibrate_options counts through the same graph: a replay a view.
    calibrated = T.calibrate_options(scene, views, options)
    assert graph.graph.replays == 4
    assert calibrated.tile_entry_capacity >= max(want)


def _assert_same_trainers(got, want):
    for f in ("colors_sh", "opacities", "positions", "rotations", "scalings"):
        assert torch.equal(getattr(got.scene, f), getattr(want.scene, f)), f
        for a, b in zip(got._opt_state["adam"][f], want._opt_state["adam"][f]):
            assert torch.equal(a, b), f
    for k, v in want._densify_acc.items():
        assert torch.equal(got._densify_acc[k], v), k
    assert torch.equal(got._entry_watermark, want._entry_watermark)


def test_fit_through_graphs_matches_the_eager_fit(cuda_device, deterministic_cudnn):
    make, pairs, targets = _fit_scan_setup(cuda_device)
    eager, graphed = make(), make()
    want, eager_launches = _counted(lambda: eager._fit_eager(pairs, targets, 13))
    got, launches = _counted(lambda: graphed.fit(pairs, targets, 13))
    graph = graphed._step_graph
    # A miss after each host event that replaces the step's tensors.
    assert graph.captures >= 2 and graph.replays >= 5 and graphed._graph.captures == 0
    assert launches == eager_launches == [13, 13, 13]
    assert graphed.scene.point_count == eager.scene.point_count > 25
    assert got == want
    _assert_same_trainers(graphed, eager)
    # With no host event, fit and fit_scan alternate without recapturing:
    # each keeps a graph of its own.
    import dataclasses

    graphed.config = dataclasses.replace(graphed.config, densify_until=0,
                                         overflow_check_interval=10**9,
                                         sh_warmup_interval=10**6)
    graphed.fit(pairs, targets, 2)
    graphed.fit_scan(pairs, targets, 2)
    counts = (graph.captures, graphed._graph.captures)
    replays = graph.replays
    graphed.fit(pairs, targets, 1)
    graphed.fit_scan(pairs, targets, 2)
    assert (graph.captures, graphed._graph.captures) == counts and graph.replays == replays + 1
    _, launches = _counted(lambda: _replay_strict(graph))
    assert launches == [1, 1, 1]


def test_train_step_batch_graph_matches_the_eager_step(cuda_device, deterministic_cudnn):
    import dataclasses

    make, pairs, targets = _fit_scan_setup(cuda_device)
    batch = pairs + pairs[:1]
    batch_targets = targets + targets[:1]
    eager, graphed = make(), make()
    for trainer in (eager, graphed):  # one SH degree over the 3 batch steps: one key
        trainer.config = dataclasses.replace(trainer.config, sh_warmup_interval=100)
    want = [eager._train_step_batch_eager(batch, batch_targets) for _ in range(3)]
    got, launches = _counted(lambda: [graphed.train_step_batch(batch, batch_targets)
                                      for _ in range(3)])
    assert (graphed._batch_graph.captures, graphed._batch_graph.replays) == (1, 2)
    assert launches == [9, 9, 9]
    for g, w in zip(got, want):
        assert {k: float(v) for k, v in g.items()} == {k: float(v) for k, v in w.items()}
    _assert_same_trainers(graphed, eager)


def test_sharded_fit_through_graphs_matches_the_eager_fit_on_nccl(
        nccl_mesh, cuda_device, deterministic_cudnn):
    make, cameras, targets = _sharded_fit_scan_setup(cuda_device, nccl_mesh)
    eager, graphed = make(), make()
    want, eager_launches = _counted(lambda: eager._fit_eager(cameras, targets, 13))
    got, launches = _counted(lambda: graphed.fit(cameras, targets, 13))
    graph = graphed._step_graph
    assert graph.captures >= 2 and graph.replays >= 5
    assert launches == eager_launches == [26, 26, 26]
    assert graphed.scene.point_count == eager.scene.point_count > 25
    assert got == want
    _assert_same_trainers(graphed, eager)


def _grad_calls(scene, views, options, render_fn, weight):
    """The sequence of differentiable renders that the graph pair is held
    to: the warm-up, the capture, a replay, a new view, two forwards then
    one backward, backwards in the reverse order, a dropped forward. Returns
    every output and gradient in order, and the launches of A, B and C of
    each step."""
    record, launches = [], []

    def render(view):
        ref = torch.zeros(scene.point_count, device=scene.device, requires_grad=True)
        out = render_fn(scene, view, options, ref)
        record.extend(t.detach() for t in out)
        return out, ref

    def backward(*pairs):
        scene.zero_grad(set_to_none=True)
        sum(torch.sum(out.colors_rgb_2d * weight) for out, _ in pairs).backward()
        record.extend(p.grad for p in scene.parameters())
        record.extend(ref.grad for _, ref in pairs)

    steps = [lambda: backward(render(views[0])) for _ in range(3)]
    steps += [lambda: backward(render(views[1])),
              lambda: backward(render(views[0]), render(views[1]))]

    def reverse():
        a, b = render(views[0]), render(views[1])
        backward(b)
        backward(a)

    def dropped():
        render(views[1])
        backward(render(views[0]))

    for step in steps + [reverse, dropped]:
        launches.append(_counted(step)[1])
    return record, launches


def test_grad_graph_matches_the_eager_render_and_backward(cuda_device):
    from gausplat_tpu_torch.render.grad_graph import grad_graph
    from gausplat_tpu_torch.render.pipeline import _render_eager

    scene, views, options = _serving_setup(cuda_device)
    graph = grad_graph("render", cuda_device)
    graph.release()
    weight = torch.randn((32, 48, 3), generator=torch.Generator().manual_seed(5)).to(cuda_device)
    got, launches = _grad_calls(scene, views, options, T.render, weight)
    assert (graph.captures, graph.replays, graph.moves) == (
        1, {"forward": 9, "backward": 8}, 2)
    eager = [[1, 1, 1]] * 4 + [[2, 2, 2], [2, 2, 2], [2, 2, 1]]
    # The capture call also runs the render and its backward once on a side
    # stream before it captures.
    assert launches == eager[:1] + [[2, 2, 2]] + eager[2:]
    assert graph.by_replay == {EXPAND: 9, RASTERIZE_FORWARD: 9, RASTERIZE_BACKWARD: 8}
    want, eager_launches = _grad_calls(scene, views, options, _render_eager, weight)
    assert eager_launches == eager and len(got) == len(want)
    for i, (a, b) in enumerate(zip(got, want)):
        assert a.shape == b.shape and torch.equal(a, b), i
    # A new point count misses: the warm-up, then the capture.
    other = T.GaussianScene.from_numpy(**scene_arrays(SMALL["p"] + 8, 6), device=cuda_device)
    got, _ = _grad_calls(other, views, options, T.render, weight)
    want, _ = _grad_calls(other, views, options, _render_eager, weight)
    assert all(torch.equal(a, b) for a, b in zip(got, want))
    assert graph.captures == 2


def test_grad_graph_replay_reads_nothing_back(cuda_device):
    from gausplat_tpu_torch.render.grad_graph import grad_graph

    scene, views, options = _serving_setup(cuda_device)
    graph = grad_graph("render", cuda_device)
    graph.release()
    for _ in range(2):  # the warm-up, the capture
        T.render(scene, views[0], options).colors_rgb_2d.sum().backward()
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:  # a whole call: the copies in, both replays, the clones out
        out = T.render(scene, views[1], options)
        out.colors_rgb_2d.sum().backward()
    finally:
        torch.cuda.set_sync_debug_mode("default")
    _, launches = _counted(lambda: _replay_strict(graph.pair.forward))
    assert launches == [1, 1, 0]
    _, launches = _counted(lambda: _replay_strict(graph.pair.backward))
    assert launches == [0, 0, 1]
    assert graph.captures == 1


def test_differentiable_render_inside_a_capture_stays_eager(cuda_device, monkeypatch):
    from gausplat_tpu_torch.render import pipeline
    from gausplat_tpu_torch.render.grad_graph import grad_graph

    scene, views, options = _serving_setup(cuda_device)
    graph = grad_graph("render", cuda_device)
    graph.release()
    taken = []

    def eager(*args, **kwargs):  # records the call; a host copy could not be captured
        taken.append(args[1])
        return torch.zeros((), device=cuda_device).add_(1.0)

    monkeypatch.setattr(pipeline, "_render_eager", eager)
    caller = torch.cuda.CUDAGraph()
    side = torch.cuda.Stream(cuda_device)
    side.wait_stream(torch.cuda.current_stream(cuda_device))
    with torch.cuda.stream(side):
        eager(None, None)
    torch.cuda.current_stream(cuda_device).wait_stream(side)
    assert scene.positions.requires_grad and torch.is_grad_enabled()
    with torch.cuda.graph(caller):
        got = T.render(scene, views[0], options)
    caller.replay()
    torch.cuda.synchronize()
    assert taken[1:] == [views[0]] and float(got) == 1.0
    assert (graph.key, graph.pair, graph.captures) == (None, None, 0)


def _batched_grad_calls(scene, call, weight):
    """The sequence of differentiable batched calls that a graph pair is held
    to: ``call(i, ref)`` renders view set ``i`` (0 or 1), with ``ref`` a
    fresh ref that requires grad; the warm-up, the capture, a replay, new
    cameras, two calls then one backward, backwards in the reverse order, a
    dropped call. Returns every output and gradient in order (a ref's
    gradient where it has one)."""
    record = []

    def render(i):
        ref = torch.zeros(scene.point_count, device=scene.device, requires_grad=True)
        out = call(i, ref)
        record.extend(t.detach() for t in out)
        return out, ref

    def backward(*pairs):
        scene.zero_grad(set_to_none=True)
        sum(torch.sum(out.colors_rgb_2d * weight) for out, _ in pairs).backward()
        record.extend(p.grad for p in scene.parameters())
        record.extend(ref.grad for _, ref in pairs if ref.grad is not None)

    for i in (0, 0, 0, 1):
        backward(render(i))
    backward(render(0), render(1))
    a, b = render(0), render(1)
    backward(b)
    backward(a)
    render(1)
    backward(render(0))
    return record


def _assert_same_records(got, want):
    assert len(got) == len(want) > 0
    for i, (a, b) in enumerate(zip(got, want)):
        assert a.shape == b.shape and torch.equal(a, b), i


#: The pair's captures, forward and backward replays and moves after
#: :func:`_batched_grad_calls`.
BATCHED_GRAD_COUNTS = (1, {"forward": 9, "backward": 8}, 2)


@pytest.mark.parametrize("mode", ["vmap", "map"])
def test_grad_views_graph_matches_the_eager_loop(mode, cuda_device):
    from gausplat_tpu_torch.render.grad_graph import grad_graph
    from gausplat_tpu_torch.render.pipeline import _render_views_eager

    scene, views, options = _serving_setup(cuda_device)
    view_sets = (views, views[::-1])
    graph = grad_graph("render_views", cuda_device)
    graph.release()
    weight = torch.randn((2, 32, 48, 3), generator=torch.Generator().manual_seed(5)).to(
        cuda_device)
    got = _batched_grad_calls(
        scene, lambda i, ref: T.render_views(scene, view_sets[i], options, mode=mode), weight)
    assert (graph.captures, graph.replays, graph.moves) == BATCHED_GRAD_COUNTS
    assert graph.by_replay == {EXPAND: 18, RASTERIZE_FORWARD: 18, RASTERIZE_BACKWARD: 16}
    want = _batched_grad_calls(
        scene, lambda i, ref: _render_views_eager(scene, view_sets[i], options, mode, None),
        weight)
    _assert_same_records(got, want)


def test_grad_views_graph_replay_reads_nothing_back(cuda_device):
    from gausplat_tpu_torch.render.grad_graph import grad_graph

    scene, views, options = _serving_setup(cuda_device)
    graph = grad_graph("render_views", cuda_device)
    graph.release()
    for _ in range(2):  # the warm-up, the capture
        T.render_views(scene, views, options).colors_rgb_2d.sum().backward()
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:  # a whole call: the copies in, both replays, the clones out
        out = T.render_views(scene, views[::-1], options, mode="map")
        out.colors_rgb_2d.sum().backward()
    finally:
        torch.cuda.set_sync_debug_mode("default")
    _, launches = _counted(lambda: _replay_strict(graph.pair.forward))
    assert launches == [2, 2, 0]
    _, launches = _counted(lambda: _replay_strict(graph.pair.backward))
    assert launches == [0, 0, 2]
    assert graph.captures == 1


def test_differentiable_render_views_inside_a_capture_stays_eager(cuda_device, monkeypatch):
    from gausplat_tpu_torch.render import pipeline
    from gausplat_tpu_torch.render.grad_graph import grad_graph

    scene, views, options = _serving_setup(cuda_device)
    graph = grad_graph("render_views", cuda_device)
    graph.release()
    taken = []

    def eager(*args, **kwargs):  # records the call; a host copy could not be captured
        taken.append(args[1])
        return torch.zeros((), device=cuda_device).add_(1.0)

    monkeypatch.setattr(pipeline, "_render_views_eager", eager)
    caller = torch.cuda.CUDAGraph()
    side = torch.cuda.Stream(cuda_device)
    side.wait_stream(torch.cuda.current_stream(cuda_device))
    with torch.cuda.stream(side):
        eager(None, None)
    torch.cuda.current_stream(cuda_device).wait_stream(side)
    assert scene.positions.requires_grad and torch.is_grad_enabled()
    with torch.cuda.graph(caller):
        got = T.render_views(scene, views, options)
    caller.replay()
    torch.cuda.synchronize()
    assert taken[1:] == [views] and float(got) == 1.0
    assert (graph.key, graph.pair, graph.captures) == (None, None, 0)


def test_parallel_render_views_grad_graph_matches_eager(cuda_device):
    from gausplat_tpu_torch.parallel import render_views, stack_cameras
    from gausplat_tpu_torch.parallel.render import _views_eager
    from gausplat_tpu_torch.render.grad_graph import grad_graph

    scene, views, options = _serving_setup(cuda_device)
    cams = [stack_cameras(v, device=cuda_device) for v in (views, views[::-1])]
    graph = grad_graph("parallel.render_views", cuda_device)
    graph.release()
    weight = torch.randn((2, 32, 48, 3), generator=torch.Generator().manual_seed(6)).to(
        cuda_device)
    got = _batched_grad_calls(
        scene, lambda i, ref: render_views(scene, cams[i], 48, 32, options), weight)
    assert (graph.captures, graph.replays, graph.moves) == BATCHED_GRAD_COUNTS
    want = _batched_grad_calls(
        scene, lambda i, ref: _views_eager(scene, cams[i], 48, 32, options), weight)
    _assert_same_records(got, want)


def test_nccl_sharded_grad_graphs_match_eager(nccl_mesh, cuda_device):
    from gausplat_tpu_torch.parallel import (
        render_data_parallel, render_tile_sharded, stack_cameras,
    )
    from gausplat_tpu_torch.parallel.render import _data_parallel_eager, _tile_sharded_eager
    from gausplat_tpu_torch.render.grad_graph import grad_graph

    scene, views, options = _serving_setup(cuda_device)
    cams = [stack_cameras(v, device=cuda_device) for v in (views, views[::-1])]
    cases = {
        "parallel.render_data_parallel": (
            lambda i, ref: render_data_parallel(scene, cams[i], 48, 32, nccl_mesh, "data",
                                                options, ref),
            lambda i, ref: _data_parallel_eager(scene, cams[i], 48, 32, nccl_mesh, "data",
                                                options, ref), (2, 32, 48, 3), 2),
        "parallel.render_tile_sharded": (
            lambda i, ref: render_tile_sharded(scene, views[i], nccl_mesh, "tiles", options,
                                               ref),
            lambda i, ref: _tile_sharded_eager(scene, views[i], nccl_mesh, "tiles", options,
                                               ref), (32, 48, 3), 1),
    }
    for name, (call, eager, shape, count) in cases.items():
        graph = grad_graph(name, cuda_device)
        graph.release()
        weight = torch.randn(shape, generator=torch.Generator().manual_seed(7)).to(cuda_device)
        got = _batched_grad_calls(scene, call, weight)
        assert (graph.captures, graph.replays, graph.moves) == BATCHED_GRAD_COUNTS, name
        _, launches = _counted(lambda: _replay_strict(graph.pair.forward))
        assert launches == [count, count, 0], name
        _, launches = _counted(lambda: _replay_strict(graph.pair.backward))
        assert launches == [0, 0, count], name
        want = _batched_grad_calls(scene, eager, weight)
        _assert_same_records(got, want)
        graph.release()  # before the fixture's process group goes
