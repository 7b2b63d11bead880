"""Counterparts of the JAX package's timing scripts in ``benchmarks/``, on one CUDA card.

``_timing.py`` is ``benchmarks/_timing.py``'s loop of chained calls. The three profiling scripts whose TPU
kernels have no counterpart on any path of the model are ported with their kernels, each kernel's wrapper and
plain PyTorch twin beside the ``main()`` that times it, as the Pallas kernels live in the JAX scripts:
``profile_r9`` (``csrc/profile_r9.cu``), ``profile_pe_ablate`` (``csrc/pe_ablate.cu``) and
``profile_compact_micro`` (``csrc/compact_micro.cu``, three kernels). Run each as
``python -m unopose_tpu_torch.benchmarks.<name>``; each prints the JSON of results its JAX script prints.
"""
