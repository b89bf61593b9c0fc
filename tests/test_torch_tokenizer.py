"""The port's tokenizer rank tables are its own copies of the JAX
package's: byte-identical, so the two can never drift apart.  Read as data;
nothing is imported."""

import os

import pytest

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.mark.parametrize("name", ["gpt2.tiktoken", "multilingual.tiktoken"])
def test_port_rank_tables_equal_jax_package(name):
    paths = [os.path.join(ROOT, pkg, "tokenizer", "assets", name)
             for pkg in ("qasr_ijcnlp_tpu", "qasr_ijcnlp_tpu_torch")]
    ref, ours = (open(p, "rb").read() for p in paths)
    assert len(ours) > 800_000
    assert ours == ref
