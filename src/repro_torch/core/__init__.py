# The CAD flow: host modules copied from the JAX package's core, plus the
# torch evaluator (eval_torch), equivalence, flow and state conversion.
