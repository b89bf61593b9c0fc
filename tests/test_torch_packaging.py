"""Every file the port opens by path under its package ships with it.

The port reads its tokenizer's rank tables (``tokenizer/bpe.py``),
compiles its CUDA sources (``_kernels.py``) and its native audio decoders
(``_native.py``) from files beside its modules, so each must match a
``[tool.setuptools.package-data]`` glob of ``pyproject.toml``, or an
installed port has no tokenizer, no kernels or no file decoders.
"""

import fnmatch
import glob
import os
import tomllib

import pytest

from qasr_ijcnlp_tpu_torch import _kernels, _native
from qasr_ijcnlp_tpu_torch.tokenizer import bpe

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PACKAGE = os.path.join(ROOT, "qasr_ijcnlp_tpu_torch")
OPENED = (sorted(glob.glob(os.path.join(bpe.ASSETS_DIR, "*.tiktoken"))) + _kernels._sources()
          + _native.sources())


def package_data():
    with open(os.path.join(ROOT, "pyproject.toml"), "rb") as f:
        return tomllib.load(f)["tool"]["setuptools"]["package-data"]


def shipped(path, data):
    """Whether ``path`` matches a glob of the package that holds it (the
    glob's directory part exactly, its file part by fnmatch)."""
    for pkg, patterns in data.items():
        pkg_dir = os.path.join(ROOT, *pkg.split("."))
        rel = os.path.relpath(path, pkg_dir)
        if rel.startswith(".."):
            continue
        for pat in patterns:
            if (os.path.dirname(rel) == os.path.dirname(pat)
                    and fnmatch.fnmatchcase(os.path.basename(rel), os.path.basename(pat))):
                return True
    return False


def test_every_opened_file_is_listed():
    """Both rank tables, every kernel source with the headers it includes,
    and the native audio sources."""
    names = {os.path.basename(p) for p in OPENED}
    assert {"gpt2.tiktoken", "multilingual.tiktoken", "flash.cu", "attention_tc.cuh",
            "common.cuh", "gemm_tc.cuh", "hopper.cuh", "wavio.cpp", "flac.cpp",
            "resample.cpp"} <= names


@pytest.mark.parametrize("path", OPENED, ids=lambda p: os.path.relpath(p, PACKAGE))
def test_opened_file_is_package_data(path):
    assert os.path.isfile(path)
    assert shipped(path, package_data()), f"{path} matches no package-data glob"
