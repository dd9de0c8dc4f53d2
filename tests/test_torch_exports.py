"""Each subpackage of the port exports every name that its counterpart in
the JAX package lists in ``__all__``. The reference lists are read from
its ``__init__.py`` files with ``ast``, so nothing here imports JAX."""

import ast
import importlib
import pathlib

import pytest

REFERENCE = pathlib.Path(__file__).resolve().parent.parent / "gausplat_tpu"
SUBPACKAGES = ("ops", "parallel", "render", "scene", "train", "utils")


def reference_all(subpackage: str) -> list:
    """The ``__all__`` list that the JAX package's ``subpackage`` assigns."""
    tree = ast.parse((REFERENCE / subpackage / "__init__.py").read_text())
    for node in tree.body:
        if isinstance(node, ast.Assign) and any(
                isinstance(t, ast.Name) and t.id == "__all__" for t in node.targets):
            return list(ast.literal_eval(node.value))
    raise AssertionError(f"gausplat_tpu/{subpackage}/__init__.py assigns no __all__")


@pytest.mark.parametrize("subpackage", SUBPACKAGES)
def test_port_exports_reference_names(subpackage):
    names = reference_all(subpackage)
    assert names
    module = importlib.import_module(f"gausplat_tpu_torch.{subpackage}")
    missing = [n for n in names if n not in getattr(module, "__all__", ())]
    assert not missing, f"gausplat_tpu_torch.{subpackage}.__all__ lacks {missing}"
    scope = {}
    exec(f"from gausplat_tpu_torch.{subpackage} import {', '.join(names)}", scope)
    assert all(scope[n] is not None for n in names)


def test_top_level_render_stays_the_function():
    import gausplat_tpu_torch as T
    from gausplat_tpu_torch.render import render

    assert callable(T.render) and T.render is render
