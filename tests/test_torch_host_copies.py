"""The port's host modules are verbatim copies of the JAX package's (the
port cannot import the originals: they reach jax, which the card's host
does not have).  Each copy must have the same AST as its original once
every import statement is removed, so the two cannot drift apart."""

import ast
import os

import pytest

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

COPIES = ["dataset.py", "hashstats.py", "index.py"] + [
    "graph/%s.py" % m for m in (
        "__init__", "core", "build", "simplify", "flow", "matepair",
        "scaffold", "genome_size", "matepair_graph")]

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


@pytest.mark.parametrize("rel", COPIES)
def test_host_copy_imports_no_jax_module(rel):
    """Absolute imports go to jax-free modules of the JAX package only;
    everything else resolves inside the port."""
    jax_free = ("metagenomics_tpu.config", "metagenomics_tpu.errors",
                "metagenomics_tpu.io.fastx", "metagenomics_tpu.native",
                "metagenomics_tpu.cs2replay", "metagenomics_tpu.mincostflow",
                "metagenomics_tpu.utils.stdsort")
    for node in _imports("metagenomics_tpu_torch", rel):
        names = ([a.name for a in node.names] if isinstance(node, ast.Import)
                 else [node.module or ""])
        if isinstance(node, ast.ImportFrom) and node.level:
            continue
        for name in names:
            assert not name.startswith("jax"), name
            if name.startswith("metagenomics_tpu."):
                assert name in jax_free, "%s imports %s" % (rel, name)
        if isinstance(node, ast.ImportFrom) and node.module == \
                "metagenomics_tpu":
            assert [a.name for a in node.names] == ["native"]


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
