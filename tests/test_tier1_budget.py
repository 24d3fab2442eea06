"""The test suite's count: no test is marked ``slow``.

The suite runs as ``pytest tests/ -m 'not slow'``, and the passes it counts are
what a change is held to. A ``slow`` mark takes a test out of that count
without a failure, so no test carries one. The sources are read, not
collected, so the check costs no JAX compile.
"""
import ast
import pathlib

TESTS = pathlib.Path(__file__).resolve().parent


def _is_slow_mark(node):
    """``<...>.mark.slow``: a mark by decorator, ``pytestmark`` or ``pytest.param``."""
    return (isinstance(node, ast.Attribute) and node.attr == "slow"
            and isinstance(node.value, ast.Attribute) and node.value.attr == "mark")


def test_no_test_is_marked_slow():
    marked = sorted(
        path.name
        for path in TESTS.glob("*.py")
        if any(_is_slow_mark(node) for node in ast.walk(ast.parse(path.read_text())))
    )
    assert marked == [], f"marked slow, so deselected from the count: {marked}"
