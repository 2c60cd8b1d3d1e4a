"""Plain references of the benchmark's configurations, in PyTorch alone:
no JAX, nothing of the JAX package or of the port.  They take the
weights and inputs the harness made (:mod:`perfkit.weights`,
:mod:`perfkit.traffic`) and work out everything else themselves, in
float32 with TF32 off, layer by layer so that a full-width model fits
beside nothing else on the card.  Every product goes through
:class:`Precision`, so the same code computed in fp8 is the control
that the comparison must reject.
"""
