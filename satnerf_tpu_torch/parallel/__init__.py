"""Training across devices: one process a device, the gradients averaged by
torch.distributed (NCCL on the card, gloo on the CPU): distributed.py joins
the group and averages, mesh.py gives each rank its rows. Counterpart of
satnerf_tpu/parallel/ (a mesh and shard_map there)."""
