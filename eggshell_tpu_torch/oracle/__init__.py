"""NumPy float64 oracles, copies of `eggshell_tpu.oracle` inside the port:
the direct LCP solvers (`lcp_oracle`) and the stepper (`sim_oracle`)."""
