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
ulp can flip a bf16 rounding)."""

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
    EXPAND_WORKLOADS, MEDIUM, SMALL, cuda_device, port_view, scene_arrays,
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
