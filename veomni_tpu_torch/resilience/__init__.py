"""Resilience subsystem: survive-and-resume as a first-class, *testable* layer.

Large multi-host TPU runs treat preemption, flaky shared filesystems, and
loss blow-ups as routine (cf. "Scalable Training of Language Models using
JAX pjit and TPUv4", PAPERS.md). This package supplies the three legs:

* ``faults``     — deterministic fault injection (``VEOMNI_FAULT_PLAN``) so
                   every recovery path below is exercisable on CPU in tier-1;
* ``retry``      — bounded deterministic-backoff retry for checkpoint and
                   data-fetch I/O;
* ``integrity``  — CRC32 manifests + verification over checkpoint
                   generations (quarantine + multi-generation restore
                   fallback) and poison-record provenance for streaming data;
* ``supervisor`` — train-loop anomaly supervision (device-side finite-loss
                   flag -> skip-step -> checkpoint rollback -> abort), a hang
                   watchdog, and SIGTERM/preemption-safe graceful shutdown;
* ``elastic``    — universal checkpoint topology: source-mesh metadata in
                   every manifest, a restore compatibility gate, and
                   world-size-aware merge/split of the per-rank data cursors
                   so a run saved on N processes resumes on M.
"""

from veomni_tpu_torch.resilience.faults import (
    FaultAction,
    InjectedFault,
    arm_from_env,
    configure_faults,
    disarm_faults,
    fault_point,
    fired_faults,
)
from veomni_tpu_torch.resilience.elastic import (
    ElasticRestoreError,
    capture_topology,
    classify_restore,
    merge_rank_states,
    split_rank_state,
)
from veomni_tpu_torch.resilience.integrity import (
    CheckpointCorruptError,
    ShardRecordError,
    VerifyReport,
    crc32_file,
    read_manifest,
    read_topology,
    verify_manifest,
    write_manifest,
)
from veomni_tpu_torch.resilience.retry import RetryPolicy, retry_call
from veomni_tpu_torch.resilience.supervisor import (
    AnomalyBudgetExceeded,
    GracefulShutdown,
    RollbackImpossible,
    SupervisorPolicy,
    TrainSupervisor,
)

__all__ = [
    "AnomalyBudgetExceeded",
    "CheckpointCorruptError",
    "ElasticRestoreError",
    "FaultAction",
    "GracefulShutdown",
    "InjectedFault",
    "RetryPolicy",
    "RollbackImpossible",
    "ShardRecordError",
    "SupervisorPolicy",
    "TrainSupervisor",
    "VerifyReport",
    "arm_from_env",
    "capture_topology",
    "classify_restore",
    "configure_faults",
    "crc32_file",
    "disarm_faults",
    "fault_point",
    "fired_faults",
    "merge_rank_states",
    "read_manifest",
    "read_topology",
    "retry_call",
    "split_rank_state",
    "verify_manifest",
    "write_manifest",
]
