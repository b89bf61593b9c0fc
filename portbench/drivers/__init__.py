"""Drivers: one module a kind of traffic, named by a mix's ``driver`` key.

Each driver has five functions, which ``portbench.run`` calls in order:

* ``setup(run) -> state``: the model and inputs from ``run.seed``, every
  shape of the cell's traffic warmed;
* ``window(state, run) -> dict``: the measured window; returns ``e2e`` (the
  end-to-end metrics by name), ``attempted``, ``failed`` and whatever the
  readers and the check need, all on the host;
* ``profiled(state, run) -> dict``: the stretch traced with ``--trace 1``
  (``trace``: ``portbench.trace.profiled``'s summary) and other per-layer
  readings;
* ``release(state)``: drop the program's state;
* ``check(run) -> {name: {"value", "limit"}}``: the reference's
  comparison of the window's outputs.
"""
