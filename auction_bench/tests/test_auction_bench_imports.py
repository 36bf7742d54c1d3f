"""Nothing under auction_bench imports JAX or the JAX package; the plain
reference imports nothing of the program.  Top-level names are compared
whole: `privacy_auction_tpu_torch` begins with `privacy_auction_tpu`."""

import ast
import pathlib

import pytest

BENCH = pathlib.Path(__file__).resolve().parents[1]
FORBIDDEN = {"jax", "jaxlib", "flax", "privacy_auction_tpu"}
PROGRAM = "privacy_auction_tpu_torch"
SOURCES = sorted(p for p in BENCH.rglob("*.py") if "__pycache__" not in p.parts)


def top_level_imports(path) -> set[str]:
    names = set()
    for node in ast.walk(ast.parse(path.read_text())):
        if isinstance(node, ast.Import):
            names |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            names.add(node.module.split(".")[0])
        elif (isinstance(node, ast.Call) and getattr(node.func, "attr", "")
              in ("import_module", "__import__") and node.args
              and isinstance(node.args[0], ast.Constant)):
            names.add(str(node.args[0].value).split(".")[0])
    return names


@pytest.mark.parametrize("path", SOURCES, ids=lambda p: str(p.relative_to(BENCH)))
def test_no_jax(path):
    assert not top_level_imports(path) & FORBIDDEN


@pytest.mark.parametrize("path", sorted((BENCH / "reference").glob("*.py")),
                         ids=lambda p: p.name)
def test_reference_imports_nothing_of_the_program(path):
    assert PROGRAM not in top_level_imports(path)


def test_whole_names_are_compared():
    assert "privacy_auction_tpu_torch".split(".")[0] not in FORBIDDEN
    assert "privacy_auction_tpu.ops".split(".")[0] in FORBIDDEN


def test_a_run_loads_no_jax():
    import subprocess
    import sys

    code = ("import sys, auction_bench.run as R, auction_bench.control, "
            "auction_bench.faults, auction_bench.drivers.seal, "
            "auction_bench.drivers.ccs22, auction_bench.trace;"
            "import privacy_auction_tpu_torch.protocols.seal, "
            "privacy_auction_tpu_torch.protocols.ccs22;"
            "print(R.jax_modules())")
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, check=True, cwd=BENCH.parent)
    assert out.stdout.strip() == "[]"
