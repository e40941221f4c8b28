"""Process group and collectives over ``torch.distributed`` (NCCL on the
card, gloo on the CPU)."""
