"""Nothing under ``benchmark/`` imports JAX, Flax, optax or the JAX package,
and no reference imports the port: every import's top-level name is
compared whole (the port's name begins with the JAX package's)."""

import ast
from pathlib import Path

import pytest

import core

BENCH = Path(core.__file__).resolve().parent
FILES = sorted(p for p in BENCH.rglob("*.py") if "__pycache__" not in p.parts)


def top_level_imports(path: Path):
    names = set()
    for node in ast.walk(ast.parse(path.read_text())):
        if isinstance(node, ast.Import):
            names.update(a.name.split(".")[0] for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0 and node.module:
            names.add(node.module.split(".")[0])
    return names


@pytest.mark.parametrize("path", FILES, ids=lambda p: str(p.relative_to(BENCH)))
def test_no_jax_import(path):
    assert not top_level_imports(path) & set(core.FORBIDDEN)


@pytest.mark.parametrize("path", sorted((BENCH / "reference").glob("*.py")),
                         ids=lambda p: p.name)
def test_reference_imports_nothing_of_the_port(path):
    assert core.PORT not in top_level_imports(path)
    assert "mtg_card_image_segmentation_tpu" not in path.read_text().replace(core.PORT, "")


def test_whole_name_rule():
    loaded = ["jax", "jax.numpy", "flax.linen", "optax", "mtg_card_image_segmentation_tpu",
              "mtg_card_image_segmentation_tpu.models", core.PORT, core.PORT + ".serving",
              "jaxtyping", "flaxen", "numpy"]
    assert core.forbidden_modules(loaded) == sorted(
        ["jax", "jax.numpy", "flax.linen", "optax", "mtg_card_image_segmentation_tpu",
         "mtg_card_image_segmentation_tpu.models"])


def test_top_level_names_taken_whole(tmp_path):
    src = tmp_path / "m.py"
    src.write_text(f"import {core.PORT}.serving\nfrom jaxtyping import Array\nimport numpy as np\n")
    assert top_level_imports(src) == {core.PORT, "jaxtyping", "numpy"}
