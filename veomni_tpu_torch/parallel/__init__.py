from veomni_tpu_torch.parallel.parallel_state import (
    ParallelState,
    destroy_parallel_state,
    get_parallel_state,
    init_parallel_state,
    use_parallel_state,
)

__all__ = [
    "ParallelState",
    "destroy_parallel_state",
    "get_parallel_state",
    "init_parallel_state",
    "use_parallel_state",
]
