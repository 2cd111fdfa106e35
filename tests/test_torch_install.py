"""Install parity of the port: setup.py's build_py builds the native
library of the JAX package and of the port, the port's loader takes its
prebuilt library as it is, and pyproject.toml names the port's script and
every one of its packages."""

import ast
import importlib.util
import os
import runpy
import shutil

import pytest

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PACKAGES = ("metagenomics_tpu", "metagenomics_tpu_torch")


def _pyproject():
    import tomllib
    with open(os.path.join(REPO, "pyproject.toml"), "rb") as f:
        return tomllib.load(f)


def test_build_py_builds_both_native_libraries(tmp_path, monkeypatch):
    if shutil.which("g++") is None:
        pytest.skip("g++ not available")
    import setuptools
    from setuptools.dist import Distribution
    captured = {}
    monkeypatch.setattr(setuptools, "setup", lambda **kw: captured.update(kw))
    runpy.run_path(os.path.join(REPO, "setup.py"))
    monkeypatch.chdir(REPO)
    natives = [p + ".native" for p in PACKAGES]
    dist = Distribution({"script_name": "setup.py", "packages": natives,
                         "package_data": {p: ["mg_native.cpp"]
                                          for p in natives}})
    cmd = captured["cmdclass"]["build_py"](dist)
    cmd.build_lib = str(tmp_path)
    cmd.ensure_finalized()
    cmd.run()
    for package in PACKAGES:
        native = tmp_path / package / "native"
        assert (native / "libmg_native.so").stat().st_size > 0, package
    # the port's loader, run from the build, loads that library unbuilt
    spec = importlib.util.spec_from_file_location(
        "built_port_native",
        tmp_path / "metagenomics_tpu_torch" / "native" / "__init__.py")
    loader = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(loader)
    monkeypatch.setattr(loader, "_build_lib", lambda: pytest.fail(
        "the prebuilt library was built again"))
    assert loader.get_lib() is not None


def test_pyproject_names_the_port():
    project = _pyproject()
    assert project["project"]["scripts"]["metagenomics-tpu-torch"] == \
        "metagenomics_tpu_torch.cli:main"
    # the script's target exists and takes argv as the CLI's main does
    with open(os.path.join(REPO, "metagenomics_tpu_torch", "cli.py")) as f:
        tree = ast.parse(f.read())
    assert "main" in {n.name for n in tree.body
                      if isinstance(n, ast.FunctionDef)}
    listed = set(project["tool"]["setuptools"]["packages"])
    for package in PACKAGES:
        for root, _, files in os.walk(os.path.join(REPO, package)):
            if "__init__.py" in files:
                name = os.path.relpath(root, REPO).replace(os.sep, ".")
                assert name in listed, name
    assert "metagenomics_tpu_torch.measure" in listed
    assert project["project"]["dependencies"] == ["numpy", "jax"]
