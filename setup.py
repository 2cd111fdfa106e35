"""Install-time build of the native C++ engine.

The runtime loaders (metagenomics_tpu/native/__init__.py and the PyTorch
port's metagenomics_tpu_torch/native/__init__.py) self-compile the engine
on first import as a fallback; building both libraries here at install time
means an installed environment never needs a compiler at runtime.  If g++
is not available the install still succeeds and the pure-Python engine is
used.
"""

import os
import subprocess

from setuptools import setup
from setuptools.command.build_py import build_py


# each package's native/ holds its own copy of mg_native.cpp
PACKAGES_WITH_NATIVE = ("metagenomics_tpu", "metagenomics_tpu_torch")


class BuildPyWithNative(build_py):
    def run(self):
        super().run()
        for package in PACKAGES_WITH_NATIVE:
            build_native(os.path.join(self.build_lib, package, "native"))


def build_native(native):
    src = os.path.join(native, "mg_native.cpp")
    out = os.path.join(native, "libmg_native.so")
    if not os.path.exists(src):
        return
    for flags in (["-O3", "-march=native"], ["-O2"]):
        cmd = ["g++", *flags, "-shared", "-fPIC", "-o", out, src]
        try:
            subprocess.run(cmd, check=True, capture_output=True)
            return
        except (OSError, subprocess.CalledProcessError):
            continue


setup(cmdclass={"build_py": BuildPyWithNative})
