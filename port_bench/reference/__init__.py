"""The plain reference of a cell's train(): NumPy and plain PyTorch only.

It imports neither JAX nor the JAX package nor anything of the program,
and takes nothing the program made: from the generator's raw columns it
works out again the holdout split, the vectorizers' design matrix, the
SanityChecker's statistics and kept columns, the folds, the bins, the
candidates' fits and fold metrics, and the winner's holdout scores, by
the published rules of TransmogrifAI's defaults (``constants.py``).
"""
