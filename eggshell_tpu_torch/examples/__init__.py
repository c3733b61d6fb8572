"""The example scripts of `examples/`, ported: one module each, run with

    python -m eggshell_tpu_torch.examples.<name> [arguments]

Each keeps its script's `main`/`build`/`solve` names, defaults and return
values, and runs on the card unless given `device="cpu"`.  A `main` that
renders takes `render: bool = True`; with `render=False` nothing imports
matplotlib, which the card's machine may lack.  The physics examples
build their scenes in float32 by default: the JAX scripts ask for
float64, which JAX gives as float32 unless x64 is switched on, as it is
not on an accelerator by default.  Importing any of these modules
imports no matplotlib.
"""
