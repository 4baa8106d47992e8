"""Multi-host bootstrap — `jax.distributed.initialize` with coordinator
retry (SURVEY.md §5.3/§5.8: the reference is single-process/single-GPU;
its bring-up analogue is the fixed-order Vulkan Context creation,
VulkanContext.cpp:26-32).

A multi-host run (config 5 beyond one host) launches one process per host;
every process calls `initialize_distributed()` before touching devices.
The function is a no-op for single-process runs (the common dev case, one
host driving all of its cards, and every test), defers to
jax.distributed's own autodetection when a cluster runtime launched it,
and retries the coordinator handshake — process 0 may come up seconds
after the rest.
"""
from __future__ import annotations

import os
import time
from typing import Optional

import jax

from ..utils.metrics import get_logger

__all__ = ["initialize_distributed", "is_distributed", "process_summary"]

_initialized = False


def is_distributed() -> bool:
    return jax.process_count() > 1


def initialize_distributed(
    coordinator_address: Optional[str] = None,
    num_processes: Optional[int] = None,
    process_id: Optional[int] = None,
    local_device_ids=None,
    retries: int = 5,
    retry_delay_s: float = 5.0,
    _initialize_fn=None,
) -> bool:
    """Initialize the multi-host runtime. Returns True if a distributed
    runtime was started, False for the single-process no-op.

    Arguments default to the standard env vars (JAX_COORDINATOR_ADDRESS,
    JAX_NUM_PROCESSES, JAX_PROCESS_ID) so launchers can configure purely
    through the environment. Under a cluster runtime that jax.distributed
    detects by itself, all three may be None — set VOLT_DISTRIBUTED=1 to
    opt in, and jax.distributed.initialize() autodetects them.
    Without the opt-in, an unconfigured environment is treated as a
    single-process run (the common dev case) and no initialize happens.

    The coordinator handshake is retried `retries` times with
    `retry_delay_s` backoff — elastic-recovery behavior for processes that
    start before the coordinator (SURVEY.md §5.3).

    _initialize_fn: test seam; defaults to jax.distributed.initialize.
    """
    global _initialized
    log = get_logger()
    coordinator_address = coordinator_address or os.environ.get(
        "JAX_COORDINATOR_ADDRESS")
    if num_processes is None:
        env = os.environ.get("JAX_NUM_PROCESSES")
        num_processes = int(env) if env else None
    if process_id is None:
        env = os.environ.get("JAX_PROCESS_ID")
        process_id = int(env) if env else None

    autodetect = (coordinator_address is None and num_processes is None
                  and os.environ.get("VOLT_DISTRIBUTED") == "1")
    if (coordinator_address is None and num_processes in (None, 1)
            and not autodetect):
        log.info("distributed: single-process run (no coordinator "
                 "configured and VOLT_DISTRIBUTED unset); skipping "
                 "jax.distributed.initialize")
        return False
    if _initialized:
        return True

    init = _initialize_fn or jax.distributed.initialize
    last_err = None
    for attempt in range(max(retries, 1)):
        try:
            init(coordinator_address=coordinator_address,
                 num_processes=num_processes,
                 process_id=process_id,
                 local_device_ids=local_device_ids)
            _initialized = True
            log.info("distributed: initialized process %s/%s via %s",
                     process_id, num_processes, coordinator_address)
            return True
        except Exception as e:  # coordinator not up yet, transient RPC
            last_err = e
            log.warning("distributed: initialize attempt %d/%d failed: %s",
                        attempt + 1, retries, e)
            if attempt + 1 < retries:
                time.sleep(retry_delay_s)
    raise RuntimeError(
        f"jax.distributed.initialize failed after {retries} attempts"
    ) from last_err


def process_summary() -> dict:
    """Per-process topology snapshot for logs/metrics (the analogue of the
    reference's device-selection log, VulkanDevice.cpp:60-63)."""
    return {
        "process_index": jax.process_index(),
        "process_count": jax.process_count(),
        "local_devices": len(jax.local_devices()),
        "global_devices": len(jax.devices()),
        "backend": jax.default_backend(),
    }
