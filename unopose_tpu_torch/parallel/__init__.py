"""The data-parallel layer (counterpart of ``unopose_tpu/parallel/``)."""
