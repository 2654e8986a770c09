from tomosar2height_jax.infer.generator import DSMGenerator, linear_blend_weight  # noqa: F401
from tomosar2height_jax.infer.evaluator import DSMEvaluator, print_statistics  # noqa: F401
