"""The guard: nothing under bench/ imports JAX or the JAX package, and the
references import nothing of the port; no file reads the JAX package's
benchmark folder."""
import ast
import pathlib
import re

import benchkit

FORBIDDEN = {"jax", "jaxlib", "flax", "repro"}
JAX_BENCH = "bench" + "marks"  # the JAX package's folder


def _imports(path: pathlib.Path) -> set:
    """The top-level names (before the first dot) of every import."""
    names = set()
    for node in ast.walk(ast.parse(path.read_text(), str(path))):
        if isinstance(node, ast.Import):
            names |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.level == 0 and node.module:
            names.add(node.module.split(".")[0])
        elif isinstance(node, ast.Call) and getattr(node.func, "attr", "") == "import_module":
            arg = node.args[0] if node.args else None
            if isinstance(arg, ast.Constant) and isinstance(arg.value, str):
                names.add(arg.value.split(".")[0])
    return names


def _modules(sub=""):
    return sorted((benchkit.BENCH / sub).rglob("*.py"))


def test_no_module_imports_jax_or_the_jax_package():
    assert _modules()
    for path in _modules():
        bad = _imports(path) & FORBIDDEN
        assert not bad, f"{path} imports {bad}"


def test_the_port_passes_the_guard_by_its_whole_name(tmp_path):
    probe = tmp_path / "probe.py"
    probe.write_text("import repro_torch\nfrom repro_torch.core import api\nimport jax.numpy\n")
    assert _imports(probe) == {"repro_torch", "jax"}
    assert _imports(probe) & FORBIDDEN == {"jax"}


def test_the_references_import_nothing_of_the_port():
    bench_local = {p.stem for p in (benchkit.BENCH / "benchlib").glob("*.py")}
    for path in _modules("reference"):
        names = _imports(path)
        assert not names & (FORBIDDEN | {"repro_torch"}), path
        # what they take from the benchmark's own library holds no program either
        for name in names & {"benchlib"}:
            for mod in ast.walk(ast.parse(path.read_text())):
                if isinstance(mod, ast.ImportFrom) and mod.module == name:
                    for alias in mod.names:
                        assert alias.name in bench_local
                        lib = benchkit.BENCH / "benchlib" / f"{alias.name}.py"
                        assert not _imports(lib) & (FORBIDDEN | {"repro_torch"}), lib


def test_no_file_reads_the_jax_packages_benchmarks():
    pattern = re.compile(r"""["'/]""" + JAX_BENCH + r"""["'/]""")
    for path in list(benchkit.BENCH.rglob("*.py")) + list(benchkit.BENCH.rglob("*.json")):
        assert not pattern.search(path.read_text()), path
