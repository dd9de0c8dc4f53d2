"""The JAX cross-check fixture for the PyTorch port's CUDA path.

The machine with the card has no JAX, so this file carries the JAX
package's answers there: small seeded scenes rendered by
``gausplat_tpu.render(backend="xla")`` on the CPU, inputs and outputs
(image, transmittance, rendered counts, radii, entry total), and the
``jax.grad`` of ``sum(image * weight)``, with ``weight`` seeded, for the
five parameters and the densification signal, stored in
``tests/data/torch_xcheck.npz``. ``chip_smoke.py`` renders the same
inputs with the port's kernels and compares (images atol 1e-4, integers
exactly, gradients atol 1e-3 scaled by each field's largest magnitude);
``tests/test_torch_fixture.py`` renders them again with JAX and checks
that the stored file still matches. The ``*_bf16`` cases render with packed
bf16 entry rows (``entry_dtype="bf16"``) on both sides.

Every case keeps a relative margin of at least ``MARGIN`` between each
(entry, pixel) alpha and the 1/255 blend threshold, and between each
pixel's running transmittance and its floor. A pair closer than that can
flip on an ulp of difference in exp or rsqrt between the CPU and the
card, which moves a whole entry's contribution (about 1/255 of a colour)
without being a fault of either side. A bf16 case also keeps every packed
value (colour, conic and opacity of each visible point, which the packing
rounds to bf16) a relative ``BF16_MARGIN`` from its rounding tie, so that
the card's projection, within about 2e-6 of the CPU's, rounds each value
as JAX does.

Regenerate, from the root of the repository:

    PYTHONPATH=. python tests/torch_fixture.py
"""

import pathlib

import numpy as np

PATH = pathlib.Path(__file__).resolve().parent / "data" / "torch_xcheck.npz"

PARAMS = ("colors_sh", "opacities", "positions", "rotations", "scalings")

#: Seeds of the bf16 cases: the first that keep both margins.
SMALL_BF16_SEED = 3
MEDIUM_BF16_SEED = 9

#: Least relative distance of any alpha from 1/255, and of any running
#: transmittance from its floor, that a case may have: some 10x the
#: relative alpha change that the card's ~1e-6 conic differences make at
#: the widest blendable exponent (0.5 * 11 * 1e-6).
MARGIN = 5e-5
#: Least relative distance of any packed f32 value from its bf16 rounding
#: tie in a bf16 case: some 5x the card's largest conic difference from
#: the CPU's (1.7e-6, ROADMAP queue 3, item 2).
BF16_MARGIN = 1e-5

#: name -> scene size and seed, camera, options.
CASES = {
    "small": dict(p=80, seed=3, width=56, height=40, position=(0.0, 0.0, -4.0),
                  sh_degree=3, tight=True, capacity=1024, block=64),
    "medium": dict(p=600, seed=38, width=96, height=64, position=(0.3, -0.2, -4.0),
                   sh_degree=3, tight=True, capacity=1 << 16, block=256),
    "reference_aabb": dict(p=300, seed=9, width=64, height=48,
                           position=(-0.2, 0.1, -3.5), sh_degree=1, tight=False,
                           capacity=4096, block=128),
    "small_bf16": dict(p=80, seed=SMALL_BF16_SEED, width=56, height=40,
                       position=(0.0, 0.0, -4.0), sh_degree=3, tight=True, capacity=1024,
                       block=64, bf16=True),
    "medium_bf16": dict(p=100, seed=MEDIUM_BF16_SEED, width=96, height=64,
                        position=(0.3, -0.2, -4.0), sh_degree=3, tight=True, capacity=1 << 14,
                        block=256, bf16=True),
}


def case_inputs(case):
    """Seeded numpy weights and the camera of one case (numpy only)."""
    c = CASES[case]
    rng = np.random.default_rng(c["seed"])
    p = c["p"]
    weights = dict(
        colors_sh=rng.standard_normal((p, 48)).astype(np.float32) * 0.4,
        positions=(rng.standard_normal((p, 3)) * 0.8).astype(np.float32),
        rotations=rng.standard_normal((p, 4)).astype(np.float32),
        scalings=np.log(0.02 + 0.15 * rng.random((p, 3))).astype(np.float32),
        opacities=(rng.standard_normal((p, 1)) * 2).astype(np.float32),
    )
    position = np.asarray(c["position"], np.float64)
    transform = np.zeros((4, 4))
    transform[:3, :3] = np.eye(3)
    transform[3, :3] = -position
    transform[3, 3] = 1.0
    view = dict(
        view_shape=np.array([1.0, 0.8, c["height"], c["width"]], np.float64),
        view_position=position,
        view_transform=transform,
        options=np.array([c["sh_degree"], int(c["tight"]), c["capacity"], c["block"],
                          int(c.get("bf16", False))], np.int64),
    )
    return weights, view


def grad_weight(case):
    """The seeded weight of the loss ``sum(image * weight)`` of one case."""
    c = CASES[case]
    rng = np.random.default_rng(c["seed"] + 1000)
    return rng.standard_normal((c["height"], c["width"], 3)).astype(np.float32)


def render_with_jax(case):
    """The JAX package's outputs and gradients for one case."""
    import jax
    import jax.numpy as jnp

    import gausplat_tpu as G

    weights, view = case_inputs(case)
    fov_x, fov_y, height, width = view["view_shape"]
    sh_degree, tight, capacity, block, bf16 = (int(x) for x in view["options"])
    scene = G.GaussianScene(**{k: jnp.asarray(v) for k, v in weights.items()})
    jview = G.View(field_of_view_x=float(fov_x), field_of_view_y=float(fov_y),
                   image_height=int(height), image_width=int(width),
                   view_position=view["view_position"],
                   view_transform=view["view_transform"])
    options = G.RenderOptions(backend="xla", colors_sh_degree_max=sh_degree,
                              tight_culling=bool(tight), tile_entry_capacity=capacity,
                              block_size=block, entry_dtype="bf16" if bf16 else "f32")
    out = G.render(scene, jview, options)
    weight = grad_weight(case)

    def loss(s, ref):
        return jnp.sum(G.render(s, jview, options, ref).colors_rgb_2d * weight)

    grads, norm = jax.grad(loss, argnums=(0, 1))(scene, jnp.zeros((CASES[case]["p"],)))
    return dict(
        image=np.asarray(out.colors_rgb_2d),
        transmittance=np.asarray(out.transmittances),
        counts=np.asarray(out.point_rendered_counts),
        radii=np.asarray(out.radii),
        total=np.asarray(out.tile_point_total),
        **{f"grad_{k}": np.asarray(getattr(grads, k)) for k in PARAMS},
        grad_norm=np.asarray(norm),
    )


def _projection(case):
    """The JAX projection and binning of a case, with its f32 rows [9, P + 1]
    and, for a bf16 case, its packed rows [6, P + 1]."""
    import jax
    import jax.numpy as jnp

    from gausplat_tpu.ops.binning import bin_gaussians
    from gausplat_tpu.ops.projection import Camera, project_gaussians
    from gausplat_tpu.ops.rasterize import pack_point_data
    import gausplat_tpu as G

    weights, view = case_inputs(case)
    fov_x, fov_y, height, width = view["view_shape"]
    sh_degree, tight, capacity, _, bf16 = (int(x) for x in view["options"])
    height, width = int(height), int(width)
    tcx, tcy = -(-width // 16), -(-height // 16)
    camera = Camera.from_view(G.View(
        field_of_view_x=float(fov_x), field_of_view_y=float(fov_y),
        image_height=height, image_width=width, view_position=view["view_position"],
        view_transform=view["view_transform"]))
    op = jnp.asarray(weights["opacities"])
    proj = project_gaussians(
        *(jnp.asarray(weights[k]) for k in ("colors_sh", "positions", "rotations", "scalings")),
        camera, sh_degree=sh_degree, tile_count_x=tcx, tile_count_y=tcy, opacities=op,
        tight_culling=bool(tight))
    binning = bin_gaussians(proj.depths, proj.tile_x_max, proj.tile_x_min, proj.tile_y_min,
                            proj.tile_counts, tile_count_x=tcx, tile_count_y=tcy,
                            capacity=capacity)
    rows = np.asarray(pack_point_data(proj, jax.nn.sigmoid(op[:, 0])))
    packed = np.asarray(pack_point_data(proj, jax.nn.sigmoid(op[:, 0]), True)) if bf16 else None
    return proj, binning, rows, packed, tcx


def _decode(packed):
    """Packed rows [6, n] -> f32 rows [9, n] (numpy)."""
    w = packed.view(np.uint32)
    hi = (w & np.uint32(0xFFFF0000)).view(np.float32)
    lo = (w << np.uint32(16)).view(np.float32)
    return np.stack([hi[0], lo[0], hi[1], hi[2], lo[2], hi[3], lo[1],
                     w[4].view(np.float32), w[5].view(np.float32)])


def threshold_margin(case):
    """The least relative distance, over every (entry, pixel) pair of the
    case as JAX bins it, of alpha from 1/255 and of the pixel's running
    transmittance (sequential, float64) from its floor; for a bf16 case,
    of the decoded rows the blend sees."""
    from gausplat_tpu.constants import OPACITY_2D_MAX, OPACITY_2D_MIN, TRANSMITTANCE_MIN

    _, binning, rows, packed, tcx = _projection(case)
    rows = (_decode(packed) if packed is not None else rows).astype(np.float64)
    ids = np.asarray(binning.point_indices)
    margin = np.inf
    lane = np.arange(256)
    for tile, (r0, r1) in enumerate(np.asarray(binning.tile_ranges)):
        if r1 <= r0:
            continue
        e = rows[:, ids[r0:r1]][:, :, None]  # [9, E, 1]
        px = (tile % tcx) * 16 + lane % 16
        py = (tile // tcx) * 16 + lane // 16
        dx, dy = e[7] - px, e[8] - py
        density = np.exp(-0.5 * (e[3] * dx * dx + 2 * e[4] * dx * dy + e[5] * dy * dy))
        alpha = np.minimum(e[6] * density, OPACITY_2D_MAX)
        margin = min(margin, np.abs(alpha / OPACITY_2D_MIN - 1).min())
        blend = np.where(alpha >= OPACITY_2D_MIN, 1 - alpha, 1.0)
        trans = np.cumprod(blend, axis=0)
        alive = np.cumprod(trans >= TRANSMITTANCE_MIN, axis=0) > 0
        near = np.abs(trans / TRANSMITTANCE_MIN - 1)
        if alive.any():
            margin = min(margin, near[alive | np.roll(alive, 1, axis=0)].min())
    return float(margin)


def bf16_margin(case):
    """For a bf16 case: the least relative distance of the f32 colour, conic
    and opacity of any visible point from the tie at which its packing
    rounds up (the bf16 truncation plus half a bf16 ulp); inf otherwise."""
    proj, _, rows, packed, _ = _projection(case)
    if packed is None:
        return float("inf")
    visible = np.asarray(proj.radii) > 0
    values = rows[:7, :-1][:, visible].astype(np.float32)
    bits = values.view(np.uint32)
    tie = ((bits & np.uint32(0xFFFF0000)) | np.uint32(0x8000)).view(np.float32)
    nonzero = values[values != 0].astype(np.float64)
    tie = tie[values != 0].astype(np.float64)
    return float((np.abs(nonzero - tie) / np.abs(nonzero)).min()) if nonzero.size else float("inf")


def build():
    """Every case's inputs and JAX outputs, keyed ``<case>/<name>``."""
    data = {}
    for case in CASES:
        weights, view = case_inputs(case)
        extra = dict(grad_weight=grad_weight(case))
        for name, value in {**weights, **view, **extra, **render_with_jax(case)}.items():
            data[f"{case}/{name}"] = value
    return data


def main():
    import jax

    jax.config.update("jax_platforms", "cpu")
    PATH.parent.mkdir(exist_ok=True)
    np.savez_compressed(PATH, **build())
    print(f"wrote {PATH} ({PATH.stat().st_size} bytes)")


if __name__ == "__main__":
    main()
