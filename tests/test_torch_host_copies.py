"""The port's host modules are verbatim copies of the JAX package's: the
port imports neither jax (the card's host does not have it) nor the JAX
package.  Each copy must have the same AST as its original once every
import statement is removed, so the two cannot drift apart; the native
loader may differ only in _build_lib, and the native C++ source is
byte-equal.  Every .py file of the port, chip_smoke.py and
multicard_smoke.py name neither jax nor metagenomics_tpu in an import."""

import ast
import glob
import os
import shutil
import subprocess
import sys

import pytest

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PORT = os.path.join(REPO, "metagenomics_tpu_torch")

COPIES = ["dataset.py", "hashstats.py", "index.py", "config.py", "errors.py",
          "io/__init__.py", "io/fastx.py", "utils/stdsort.py",
          "cs2replay.py", "mincostflow.py", "tools/__init__.py",
          "tools/fac.py", "tools/format_fasta.py", "tools/shuffle.py"] + [
    "graph/%s.py" % m for m in (
        "__init__", "core", "build", "simplify", "flow", "matepair",
        "scaffold", "genome_size", "matepair_graph")]

# every .py file of the port, and the on-card checks beside it
PORT_FILES = sorted(
    os.path.relpath(p, PORT)
    for p in glob.glob(os.path.join(PORT, "**", "*.py"), recursive=True)
) + [os.path.join("..", "chip_smoke.py"),
     os.path.join("..", "multicard_smoke.py")]

# functions of ops/packing.py whose host half the port copies
PACKING_FUNCS = ["ascii_to_codes", "codes_to_ascii",
                 "reverse_complement_codes_np", "_lex_less_np",
                 "canonicalize_codes_np", "qc_mask_np",
                 "codes_to_ascii_all", "pack_sort_limbs"]
# its device half, ported to torch (tests/test_torch_packing.py)
PACKING_DEVICE_FUNCS = ["reverse_complement_codes", "_lex_less",
                        "canonicalize_codes", "_qc_kernel", "qc_mask"]


class _DropImports(ast.NodeTransformer):
    def visit_Import(self, node):
        return None

    def visit_ImportFrom(self, node):
        return None


def _tree(pkg, rel):
    with open(os.path.join(REPO, pkg, rel)) as f:
        return _DropImports().visit(ast.parse(f.read()))


def _imports(pkg, rel):
    with open(os.path.join(REPO, pkg, rel)) as f:
        tree = ast.parse(f.read())
    return [n for n in ast.walk(tree)
            if isinstance(n, (ast.Import, ast.ImportFrom))]


@pytest.mark.parametrize("rel", COPIES)
def test_host_copy_equals_original(rel):
    assert ast.dump(_tree("metagenomics_tpu_torch", rel)) == \
        ast.dump(_tree("metagenomics_tpu", rel)), \
        "%s drifted from metagenomics_tpu/%s" % (rel, rel)


@pytest.mark.parametrize("rel", PORT_FILES)
def test_host_copy_imports_no_jax_module(rel):
    """No import of the port (absolute or relative) names jax or the JAX
    package; relative imports stay inside the port."""
    for node in _imports("metagenomics_tpu_torch", rel):
        if isinstance(node, ast.ImportFrom) and node.level:
            continue
        names = ([a.name for a in node.names] if isinstance(node, ast.Import)
                 else [node.module or ""])
        for name in names:
            top = name.split(".")[0]
            assert top != "jax", "%s imports %s" % (rel, name)
            assert top != "metagenomics_tpu", "%s imports %s" % (rel, name)


def test_native_loader_equals_original_but_build():
    """native/__init__.py node by node, except _build_lib (the port's takes
    a lock and a per-process temp file)."""
    def nodes(pkg):
        tree = _tree(pkg, "native/__init__.py")
        return [ast.dump(n) for n in tree.body
                if not (isinstance(n, ast.FunctionDef)
                        and n.name == "_build_lib")]
    port, ref = nodes("metagenomics_tpu_torch"), nodes("metagenomics_tpu")
    assert port == ref
    names = [n.name for n in _tree("metagenomics_tpu_torch",
                                   "native/__init__.py").body
             if isinstance(n, ast.FunctionDef)]
    assert "_build_lib" in names


def test_native_source_byte_equal():
    rel = os.path.join("native", "mg_native.cpp")
    with open(os.path.join(PORT, rel), "rb") as a, \
            open(os.path.join(REPO, "metagenomics_tpu", rel), "rb") as b:
        assert a.read() == b.read()


# load a fresh copy of the port's native loader from argv[1] and exit 0
# only if get_lib() returned the library
_GET_LIB = """
import importlib.util, os, sys
spec = importlib.util.spec_from_file_location(
    "native_copy", os.path.join(sys.argv[1], "__init__.py"))
mod = importlib.util.module_from_spec(spec)
spec.loader.exec_module(mod)
sys.exit(0 if mod.get_lib() is not None else 1)
"""


def test_native_concurrent_first_builds(tmp_path):
    """Six processes build a fresh copy of the library at once; each gets
    it (the reference loader's first builds race on one temp file)."""
    pkg = tmp_path / "native"
    pkg.mkdir()
    for name in ("__init__.py", "mg_native.cpp"):
        shutil.copy(os.path.join(PORT, "native", name), pkg / name)
    procs = [subprocess.Popen([sys.executable, "-c", _GET_LIB, str(pkg)])
             for _ in range(6)]
    rcs = [p.wait(timeout=600) for p in procs]
    assert rcs == [0] * 6
    assert (pkg / "libmg_native.so").exists()
    assert not glob.glob(str(pkg / "*.tmp"))


def test_packing_host_half_equals_original():
    def funcs(pkg):
        tree = _tree(pkg, "ops/packing.py")
        return {n.name: ast.dump(n) for n in tree.body
                if isinstance(n, ast.FunctionDef)}
    port, ref = funcs("metagenomics_tpu_torch"), funcs("metagenomics_tpu")
    for name in PACKING_FUNCS:
        assert port[name] == ref[name], name
    assert set(port) == set(PACKING_FUNCS) | set(PACKING_DEVICE_FUNCS)
    assert set(ref) == set(port)
