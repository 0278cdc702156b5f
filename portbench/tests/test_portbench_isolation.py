"""Nothing of the benchmark imports JAX or the JAX package, and the
reference and the work counts import nothing of the port: every import
statement, by its module's whole top-level name."""
import ast
import os

import pytest

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
JAX = {"jax", "jaxlib", "flax", "rnaelem_tpu"}


def _files(sub=""):
    base = os.path.join(HERE, sub)
    for d, _, fs in os.walk(base):
        for f in fs:
            if f.endswith(".py"):
                yield os.path.join(d, f)


def _top_names(path):
    tree = ast.parse(open(path).read(), path)
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for a in node.names:
                yield a.name.split(".")[0]
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module.split(".")[0]


@pytest.mark.parametrize("path", sorted(_files()))
def test_no_jax_anywhere(path):
    assert not set(_top_names(path)) & JAX, path


@pytest.mark.parametrize("path", sorted(_files("reference")) +
                         sorted(_files("work")))
def test_reference_and_counts_import_nothing_of_the_port(path):
    names = set(_top_names(path))
    assert "rnaelem_tpu_torch" not in names, path
    assert "portbench" not in names or "work" in path, path
