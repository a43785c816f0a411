"""Multi-device sharding on torch.distributed: the mesh, the distributed NTT
and the sharded MSM (the port of ``snarkos_tpu/parallel/``).

Each rank is one process with one device. The heavy kernels run on each
rank's shard, and the ranks exchange data with collectives: all_to_all
for the four-step NTT's stage exchange, all_gather and a tree reduce for
the MSM's partial sums. NCCL carries them between cards, gloo between CPU
processes (and between processes that share one card).
"""
