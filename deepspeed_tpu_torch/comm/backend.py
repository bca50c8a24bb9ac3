"""Communication backend (counterpart of ``deepspeed_tpu/comm/backend.py``;
the reference's ``deepspeed/comm/torch.py:11`` ``TorchBackend``).

:class:`TorchBackend` runs over ``torch.distributed``: NCCL on the card,
gloo on the CPU. Its collectives carry dense tensors only; the int8 and
1-bit wire tiers of the JAX ``XlaBackend`` come with the
compressed-collectives slice.
"""


class Backend:
    # wire formats the backend's collectives can carry
    comm_dtypes = ("dense",)

    def __init__(self, name="backend", rank=0, size=1):
        self.name = name
        self.world_group = None
        self.world_size = size
        self.world_rank = rank
        self.process_groups = []
        self.initialized = False

    def is_initialized(self):
        return self.initialized

    def supports_comm_dtype(self, comm_dtype: str) -> bool:
        return comm_dtype in self.comm_dtypes

    def new_group(self, ranks):
        raise NotImplementedError

    def init_process_group(self):
        self.initialized = True


class TorchBackend(Backend):
    """``torch.distributed`` with the process group already running
    (:func:`deepspeed_tpu_torch.comm.init_distributed` starts it)."""

    def __init__(self, name=None):
        import torch.distributed as dist

        super().__init__(name=name or dist.get_backend(),
                         rank=dist.get_rank(), size=dist.get_world_size())
        self.world_group = dist.group.WORLD
        self.initialized = True

    def is_initialized(self):
        import torch.distributed as dist

        return self.initialized and dist.is_initialized()

    def new_group(self, ranks):
        """A process group over ``ranks``; every rank of the world must
        call it, in the same order."""
        import torch.distributed as dist

        group = dist.new_group(sorted(ranks))
        self.process_groups.append(group)
        return group
