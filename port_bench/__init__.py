"""The benchmark of ``transmogrifai_tpu_torch`` on NVIDIA GPUs (see
``run.py`` and PERF.md at the repository's root)."""
