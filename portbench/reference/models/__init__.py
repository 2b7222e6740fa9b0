"""Reference models, one module a model family (the configuration's
``family``), each with ``param_specs``, ``precon_paths``, ``loss`` and
``train_flops``."""
