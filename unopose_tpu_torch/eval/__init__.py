from unopose_tpu_torch.eval.pose_error import add, adi, mspd, mssd, vsd_from_depths
from unopose_tpu_torch.eval.bop_eval import evaluate_bop
