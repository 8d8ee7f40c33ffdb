"""Plan and execution verifiers of the port.

Counterpart of the JAX package's analysis/ package, cut to what the port
runs so far: `plan_check.verify_grace`, the postconditions of a
grace-split join stage.
"""
