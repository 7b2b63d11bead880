from unopose_tpu_torch.models.unopose import UNOPose

__all__ = ["UNOPose"]
