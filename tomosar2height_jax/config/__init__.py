from tomosar2height_jax.config.compose import Config, compose, load_yaml, parse_cli_overrides  # noqa: F401
