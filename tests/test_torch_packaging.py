"""The port's package data: an installed (not editable) port builds its
kernels from the ``csrc/`` it ships, and its host batch prep from
``data/_native/``, so every file a kernel source includes, and the native
source, must be matched by a glob of ``setup.py``'s ``package_data``."""

import ast
import fnmatch
import os
import re

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PACKAGE = "convnet_approximater_tpu_torch"


def package_data() -> dict:
    """``setup(package_data=...)`` of ``setup.py``, read without running it."""
    tree = ast.parse(open(os.path.join(REPO, "setup.py")).read())
    for node in ast.walk(tree):
        if isinstance(node, ast.keyword) and node.arg == "package_data":
            return ast.literal_eval(node.value)
    raise AssertionError("setup.py passes no package_data")


def test_every_kernel_include_is_shipped():
    globs = package_data()[PACKAGE]
    csrc = os.path.join(REPO, PACKAGE, "csrc")
    sources = sorted(f for f in os.listdir(csrc) if f.endswith(".cu"))
    assert len(sources) == 4
    includes = set()
    for name in sources:
        assert any(fnmatch.fnmatch(f"csrc/{name}", g) for g in globs), name
        text = open(os.path.join(csrc, name)).read()
        includes |= set(re.findall(r'^\s*#\s*include\s+"([^"]+)"', text, re.M))
    assert includes, "the kernel sources include no header of their own"
    for inc in sorted(includes):
        rel = os.path.normpath(os.path.join("csrc", inc))
        assert os.path.isfile(os.path.join(REPO, PACKAGE, rel)), inc
        assert any(fnmatch.fnmatch(rel, g) for g in globs), f"{rel} is not in package_data"


def test_the_native_batch_prep_source_is_shipped():
    from convnet_approximater_tpu_torch.data import native

    rel = os.path.relpath(native.SOURCE, os.path.join(REPO, PACKAGE))
    assert rel == os.path.join("data", "_native", "batch_prep.cpp")
    assert any(fnmatch.fnmatch(rel, g) for g in package_data()[PACKAGE]), rel
