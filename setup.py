"""Build script: pure-python package + optional native CPU backend.

The C++ OpenMP wavefront solver (sigkernel_jax/csrc/solver.cpp) is compiled
as a plain shared library loaded via ctypes -- build it with
``python setup.py build_native`` or the Makefile target; the package works
without it (the JAX scan solver covers CPU).
"""
import os
import subprocess
import sys

from setuptools import setup, Command


class BuildNative(Command):
    description = "compile the native C++ CPU solver"
    user_options = []

    def initialize_options(self):
        pass

    def finalize_options(self):
        pass

    def run(self):
        src = os.path.join("sigkernel_jax", "csrc", "solver.cpp")
        out = os.path.join("sigkernel_jax", "csrc", "libsigsolver.so")
        cmd = ["g++", "-O3", "-march=native", "-fopenmp", "-shared", "-fPIC",
               "-std=c++17", src, "-o", out]
        print(" ".join(cmd))
        subprocess.check_call(cmd)


setup(cmdclass={"build_native": BuildNative})
