"""One-off diagnostics of the port's kernels on the card, each a module run
with ``python3 -m``:

* :mod:`.attn_parts` — the attention core's cost split into its products
  and its softmax (K11)
* :mod:`.step_formulations` — the decode step's cross-attention in four
  formulations against the read floor (K12)
"""
