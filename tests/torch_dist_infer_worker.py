"""Worker of ``tests/test_torch_distributed.py``'s two-rank inference test:
one gloo rank of the port's ``run_inference`` on ``tests/test_inference.py``'s
``FakeDataset`` with its fake model function.

Started one process a rank under torchrun's environment by the test: each
rank writes its shard of the images (``.rank<N>`` past rank 0), all pass a
barrier, rank 0 merges the shards, all pass a second barrier.
"""

import argparse
import os.path as osp
import sys

REPO = osp.dirname(osp.dirname(osp.abspath(__file__)))
sys.path.insert(0, REPO)
sys.path.insert(0, osp.join(REPO, "tests"))


def main():
    p = argparse.ArgumentParser()
    p.add_argument("--out", required=True)
    args = p.parse_args()

    import torch

    from test_inference import FakeDataset, _fake_infer_fn
    from unopose_tpu_torch.engine.inference import merge_csv_shards, run_inference
    from unopose_tpu_torch.parallel import mesh

    mesh.init_distributed("cpu")
    try:
        run_inference(_fake_infer_fn, FakeDataset(n_images=5, seed=7), args.out, instance_batch_size=2,
                      num_shards=mesh.world_size(), shard_index=mesh.rank())
        mesh.sync_processes("eval_done")
        if mesh.is_main_process():
            merge_csv_shards(args.out, mesh.world_size())
        mesh.sync_processes("merged")
    finally:
        torch.distributed.destroy_process_group()


if __name__ == "__main__":
    main()
