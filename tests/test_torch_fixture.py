"""The stored JAX cross-check fixture (tests/data/torch_xcheck.npz), which
chip_smoke.py holds the CUDA path against on the card.

- It is current: JAX renders its inputs again to the stored outputs, and
  no (entry, pixel) pair sits within ``MARGIN`` of a blend threshold; in
  the bf16 cases no packed value sits within ``BF16_MARGIN`` of its
  rounding tie.
- The port's plain path renders it within atol=1e-4, integers exactly,
  and its gradients (five parameters and the densification signal) match
  the stored ``jax.grad`` within 1e-4 scaled by each field's largest
  magnitude.
- The sequential per-pixel order of the CUDA kernel, run here through the
  oracle of tests/oracle.py on the port's entry data (decoded, in the
  bf16 cases), gives the stored rendered counts exactly; so the card's
  exact-count check tests the kernel, not a rounding coincidence of the
  fixture."""

import numpy as np
import pytest
import torch

import gausplat_tpu_torch as T
from gausplat_tpu_torch.ops.binning import bin_gaussians
from gausplat_tpu_torch.ops.blend import pack_rows, unpack_rows
from gausplat_tpu_torch.ops.projection import Camera, project_gaussians
from gausplat_tpu_torch.ops.rasterize import pack_point_data

import oracle
from tests import torch_fixture

STORED = dict(np.load(torch_fixture.PATH))


def _stored(case):
    return {k.split("/", 1)[1]: v for k, v in STORED.items() if k.startswith(case + "/")}


def _port_inputs(case):
    g = _stored(case)
    scene = T.GaussianScene.from_numpy(**{k: g[k] for k in torch_fixture.PARAMS}, device="cpu")
    fov_x, fov_y, height, width = g["view_shape"]
    view = T.View(field_of_view_x=float(fov_x), field_of_view_y=float(fov_y),
                  image_height=int(height), image_width=int(width),
                  view_position=g["view_position"], view_transform=g["view_transform"])
    sh_degree, tight, capacity, block, bf16 = (int(x) for x in g["options"])
    options = T.RenderOptions(colors_sh_degree_max=sh_degree, tight_culling=bool(tight),
                              tile_entry_capacity=capacity, block_size=block,
                              entry_dtype="bf16" if bf16 else "f32")
    return g, scene, view, options


#: Stored gradients against JAX's, each field scaled by its largest
#: magnitude. XLA CPU builds and hosts differ in the order of their fused
#: sums, so a staleness check at 1e-6 depends on the host. Largest scaled
#: differences over the three cases on one x86 host with JAX 0.9.0:
#: colors_sh 1.6e-6, positions 1.3e-6, norm 1.1e-6, opacities 1.0e-6,
#: scalings 4.9e-6, rotations 7.8e-6. Each limit leaves at least 6x room
#: above its reading and stays tighter than the port's 1e-4 against
#: ``jax.grad`` (and the card's 1e-3). Images and transmittances keep
#: 1e-6, integers stay exact.
GRAD_STALE_ATOL = {"grad_scalings": 5e-5, "grad_rotations": 5e-5}
GRAD_STALE_ATOL_DEFAULT = 1e-5


@pytest.mark.parametrize("case", sorted(torch_fixture.CASES))
def test_fixture_is_current(case):
    weights, view = torch_fixture.case_inputs(case)
    g = _stored(case)
    for name, value in {**weights, **view, "grad_weight": torch_fixture.grad_weight(case)}.items():
        np.testing.assert_array_equal(g[name], value, err_msg=name)
    stale = {}
    for name, value in torch_fixture.render_with_jax(case).items():
        if name.startswith("grad_"):
            scale = np.abs(value).max()
            err = float(np.abs(g[name] / scale - value / scale).max())
            limit = GRAD_STALE_ATOL.get(name, GRAD_STALE_ATOL_DEFAULT)
            if err > limit:
                stale[name] = (err, limit)
        elif value.dtype.kind == "f":
            np.testing.assert_allclose(g[name], value, atol=1e-6, rtol=0, err_msg=name)
        else:
            np.testing.assert_array_equal(g[name], value, err_msg=name)
    assert not stale, f"stored gradients are stale (scaled error, limit): {stale}"


@pytest.mark.parametrize("case", sorted(torch_fixture.CASES))
def test_fixture_keeps_threshold_margin(case):
    assert torch_fixture.threshold_margin(case) >= torch_fixture.MARGIN
    assert torch_fixture.bf16_margin(case) >= torch_fixture.BF16_MARGIN


@pytest.mark.parametrize("case", sorted(torch_fixture.CASES))
def test_port_matches_fixture(case):
    g, scene, view, options = _port_inputs(case)
    out = T.render(scene, view, options)
    np.testing.assert_allclose(out.colors_rgb_2d.detach().numpy(), g["image"], atol=1e-4, rtol=0)
    np.testing.assert_allclose(out.transmittances.detach().numpy(), g["transmittance"], atol=1e-4, rtol=0)
    np.testing.assert_array_equal(out.point_rendered_counts.detach().numpy(), g["counts"])
    np.testing.assert_array_equal(out.radii.detach().numpy(), g["radii"])
    assert int(out.tile_point_total) == int(g["total"])


@pytest.mark.parametrize("case", sorted(torch_fixture.CASES))
def test_port_grads_match_fixture(case):
    g, scene, view, options = _port_inputs(case)
    ref = torch.zeros(scene.point_count, requires_grad=True)
    out = T.render(scene, view, options, ref)
    torch.sum(out.colors_rgb_2d * torch.as_tensor(g["grad_weight"])).backward()
    got = {f"grad_{k}": getattr(scene, k).grad.numpy() for k in torch_fixture.PARAMS}
    got["grad_norm"] = ref.grad.numpy()
    for name, value in got.items():
        scale = np.abs(g[name]).max()
        assert scale > 0, name
        np.testing.assert_allclose(value / scale, g[name] / scale, atol=1e-4, rtol=0,
                                   err_msg=name)


@pytest.mark.parametrize("case", sorted(torch_fixture.CASES))
def test_sequential_order_matches_fixture(case):
    g, scene, view, options = _port_inputs(case)
    tcx, tcy = -(-view.image_width // 16), -(-view.image_height // 16)
    with torch.no_grad():
        proj = project_gaussians(
            scene.colors_sh, scene.positions, scene.rotations, scene.scalings,
            Camera.from_view(view, device="cpu"), sh_degree=options.colors_sh_degree_max,
            tile_count_x=tcx, tile_count_y=tcy, opacities=scene.opacities,
            tight_culling=options.tight_culling,
        )
        binning = bin_gaussians(
            proj.depths, proj.tile_x_max, proj.tile_x_min, proj.tile_y_min,
            proj.tile_counts, tile_count_x=tcx, tile_count_y=tcy,
            capacity=options.tile_entry_capacity,
        )
        rows = pack_point_data(proj, torch.sigmoid(scene.opacities[:, 0]))
        if options.entry_dtype == "bf16":
            rows = unpack_rows(pack_rows(rows))
    image, trans, counts = oracle.rasterize_forward(
        rows.numpy().T[:-1], binning.point_indices.numpy(), binning.tile_ranges.numpy(),
        view.image_width, view.image_height, tcx,
    )
    np.testing.assert_allclose(image, g["image"], atol=5e-5, rtol=0)
    np.testing.assert_allclose(trans, g["transmittance"], atol=5e-5, rtol=0)
    np.testing.assert_array_equal(counts, g["counts"])
