"""Nothing under portbench/ imports JAX or the JAX package, or reads the
JAX-era benchmark's files; the top-level module name is compared whole,
since the port's name begins with the JAX package's."""

import ast
import re
from pathlib import Path

BENCH = Path(__file__).resolve().parent.parent
FORBIDDEN = {"jax", "jaxlib", "flax", "tensorf_tpu"}


def sources():
    return sorted(BENCH.rglob("*.py"))


def imported_tops(path: Path):
    tree = ast.parse(path.read_text(), filename=str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for a in node.names:
                yield a.name.split(".")[0]
        elif isinstance(node, ast.ImportFrom) and node.level == 0 and node.module:
            yield node.module.split(".")[0]
        elif (isinstance(node, ast.Call) and getattr(node.func, "attr", "") == "import_module"
              and node.args and isinstance(node.args[0], ast.Constant)):
            yield str(node.args[0].value).split(".")[0]


def test_no_module_imports_jax_or_the_jax_package():
    found = {str(p.relative_to(BENCH)): sorted(set(imported_tops(p)) & FORBIDDEN)
             for p in sources()}
    assert not {k: v for k, v in found.items() if v}
    assert "tensorf_tpu_torch" in {t for p in sources() for t in imported_tops(p)}


def test_no_module_reads_the_jax_benchmark_files():
    for p in sources():
        text = p.read_text()
        if p.name == Path(__file__).name:
            continue
        assert not re.search(r"(?<![\w.])bench\.py|(?<!\w)BENCH_\w*\.json", text), p
