"""The command line's helpers: the composition template evaluator."""
