"""Worker of ``tests/test_torch_distributed_pe.py``: one gloo rank of the
fine PE's train stack with its BatchNorm statistics reduced across the
ranks.

Started one process a rank under torchrun's environment (``RANK``,
``WORLD_SIZE``, ``MASTER_ADDR``, ``MASTER_PORT``) by the test. Reads the
global inputs (``--inputs``, an ``.npz`` of ``chans``, the weights, gammas,
betas and the cotangent weights ``R``), takes this rank's rows
(``local_batch_slice``) and runs each route: the passes in the kernels'
structure (``pe_mlp_bn_pool_train``, bf16 rounding points) and the autograd
formulation (``pe_mlp_bn_pool_train_plain``) in float32 and bf16. The local
loss is ``sum(pooled * R)`` over the rank's rows; the gradients are
averaged across the ranks (``average_gradients``). Writes ``--out`` with a
``.rank<N>`` suffix: per route its pooled rows, statistics and averaged
gradients, and the collectives it launched.
"""

import argparse
import os.path as osp
import sys

REPO = osp.dirname(osp.dirname(osp.abspath(__file__)))
sys.path.insert(0, REPO)

ROUTES = ("passes", "autograd_float32", "autograd_bfloat16")


def run_route(route, chans, Ws, gammas, betas, R):
    """pooled, [means, variances] and the averaged gradients (Ws, gammas, betas) of one route."""
    import torch

    from unopose_tpu_torch.ops import pe_train
    from unopose_tpu_torch.parallel import mesh

    params = [torch.from_numpy(x).requires_grad_() for x in (*Ws, *gammas, *betas)]
    args = (torch.from_numpy(chans), params[:3], params[3:6], params[6:])
    if route == "passes":
        pooled, (mus, vars_) = pe_train.pe_mlp_bn_pool_train(*args)
    else:
        pooled, (mus, vars_) = pe_train.pe_mlp_bn_pool_train_plain(*args, mm_dtype=getattr(torch, route.split("_")[1]))
    (pooled * torch.from_numpy(R)).sum().backward()
    mesh.average_gradients(params)
    return pooled.detach().numpy(), [m.numpy() for m in (*mus, *vars_)], [p.grad.numpy() for p in params]


def main():
    p = argparse.ArgumentParser()
    p.add_argument("--inputs", required=True)
    p.add_argument("--out", required=True)
    args = p.parse_args()

    import numpy as np
    import torch

    from unopose_tpu_torch.parallel import mesh

    torch.set_num_threads(1)
    mesh.init_distributed("cpu")
    try:
        with np.load(args.inputs) as z:
            rows = mesh.local_batch_slice(z["chans"].shape[0])
            chans, R = z["chans"][rows], z["R"][rows]
            Ws, gammas, betas = ([z[f"{name}{i}"] for i in range(3)] for name in ("W", "gamma", "beta"))
        out = dict(rows=np.array([rows.start, rows.stop]))
        for route in ROUTES:
            pooled, stats, grads = run_route(route, chans, Ws, gammas, betas, R)
            out[f"{route}_pooled"] = pooled
            out.update({f"{route}_stat{i}": s for i, s in enumerate(stats)})
            out.update({f"{route}_grad{i}": g for i, g in enumerate(grads)})
        out.update({f"reductions_{k}": np.array(v) for k, v in mesh.REDUCTIONS.items()})
        np.savez(f"{args.out}.rank{mesh.rank()}", **out)
        mesh.sync_processes("done")
    finally:
        torch.distributed.destroy_process_group()


if __name__ == "__main__":
    main()
