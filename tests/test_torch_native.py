"""The port's PLY payload codec: the host C++ library
(``gausplat_tpu_torch/utils/native.py``, built here with the host
compiler) against the numpy twins of ``scene/ply.py`` and the JAX
package's ``encode_polygon``, bit for bit; wrong sizes, a big-endian
payload, a failed build, and no compiler."""

import numpy as np
import pytest

import gausplat_tpu_torch as T
from gausplat_tpu_torch.errors import KernelError
from gausplat_tpu_torch.scene import ply
from gausplat_tpu_torch.utils import native

FIELDS = ply.FIELDS


def _codec_scene(p):
    from torch_helpers import scene_arrays

    arrays = scene_arrays(max(p, 1), seed=5)
    return {k: v[:p] for k, v in arrays.items()}


@pytest.mark.parametrize("p", [0, 300])
def test_native_codec_matches_numpy_and_jax(p):
    import jax.numpy as jnp

    import gausplat_tpu as G

    assert native.available()
    arrays = _codec_scene(p)
    fields = [arrays[f] for f in FIELDS]
    payload = native.encode_payload(*fields)
    assert payload == ply.encode_payload_numpy(*fields)
    blob = T.encode_polygon(T.GaussianScene.from_numpy(**arrays, device="cpu"))
    assert blob.endswith(payload) and len(blob) > len(payload)
    assert blob == G.encode_polygon(G.GaussianScene(**{k: jnp.asarray(v)
                                                       for k, v in arrays.items()}))
    decoded = {"native": native.decode_payload(payload, p),
               "numpy": ply.decode_payload_numpy(payload, p),
               "polygon": [getattr(T.decode_polygon(blob, device="cpu"), f).detach().numpy()
                           for f in FIELDS]}
    for path, back in decoded.items():
        for f, got in zip(FIELDS, back):
            np.testing.assert_array_equal(got.view(np.int32), arrays[f].view(np.int32),
                                          err_msg=f"{path} {f}")


def test_native_codec_rejects_wrong_sizes():
    arrays = [v for v in (_codec_scene(10)[f] for f in FIELDS)]
    payload = native.encode_payload(*arrays)
    assert len(payload) == 10 * 62 * 4
    with pytest.raises(ValueError, match="buffer sizes"):
        native.decode_payload(payload[:-4], 10)
    with pytest.raises(ValueError, match="buffer sizes"):
        native.encode_payload(*arrays[:2], arrays[2][:9], *arrays[3:])
    got = native.decode_payload(payload, 10)
    for a, want in zip(got, arrays):
        np.testing.assert_array_equal(a, want)


def test_big_endian_payload_takes_numpy():
    arrays = _codec_scene(7)
    blob = T.encode_polygon(T.GaussianScene.from_numpy(**arrays, device="cpu"))
    head, payload = blob.split(b"end_header\n", 1)
    swapped = (head.replace(b"binary_little_endian", b"binary_big_endian") + b"end_header\n"
               + np.frombuffer(payload, "<f4").astype(">f4").tobytes())
    back = T.decode_polygon(swapped, device="cpu")
    for f in FIELDS:
        np.testing.assert_array_equal(getattr(back, f).detach().numpy(), arrays[f])


def test_failed_build_raises_and_no_compiler_takes_numpy(tmp_path, monkeypatch):
    broken = tmp_path / "ply_codec.cpp"
    broken.write_text("this is not C++\n")
    monkeypatch.setattr(native, "SOURCE", broken)
    with pytest.raises(KernelError, match="failed"):
        native.encode_payload(*(_codec_scene(3)[f] for f in FIELDS))
    # Without a compiler the numpy path runs (the broken source is never built).
    monkeypatch.setattr(native, "find_cxx", lambda: None)
    assert not native.available()
    arrays = _codec_scene(3)
    blob = T.encode_polygon(T.GaussianScene.from_numpy(**arrays, device="cpu"))
    assert blob.endswith(ply.encode_payload_numpy(*(arrays[f] for f in FIELDS)))
    back = T.decode_polygon(blob, device="cpu")
    for f in FIELDS:
        np.testing.assert_array_equal(getattr(back, f).detach().numpy(), arrays[f])
