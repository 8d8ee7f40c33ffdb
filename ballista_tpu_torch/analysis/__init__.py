"""Plan and execution verifiers of the port.

Counterpart of the JAX package's analysis/ package, cut to what the port
runs so far: `plan_check`, the static verifier over staged physical plans
and ExecutionGraphs (`verify_stages`, `verify_graph`, the skew-split and
lease-band checks) and the postconditions of a grace-split join stage
(`verify_grace`). The static-analysis passes are not ported (ROADMAP A10).
"""
