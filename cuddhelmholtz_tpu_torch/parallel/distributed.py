"""Multi-process execution on ``torch.distributed``: start-up, meshes, CPU ranks.

Counterpart of ``cuddhelmholtz_tpu/parallel/distributed.py``.  One process
per device (SPMD), as ``torchrun`` starts them:

  * every process calls :func:`initialize_from_env` once at start-up.  The
    ``CUDDH_COORDINATOR`` / ``CUDDH_NUM_PROCESSES`` / ``CUDDH_PROCESS_ID``
    variables (or the arguments) give the rendezvous address, the world
    size and this process's rank; without them the ``torchrun`` variables
    (``MASTER_ADDR``, ``WORLD_SIZE``, ``RANK``) are used when present.  The
    backend is NCCL for CUDA tensors and gloo on the CPU;
  * :func:`hybrid_device_mesh` builds the 2-axis ``("dcn", "ici")``
    ``DeviceMesh``: the outer axis crosses hosts, the inner axis holds one
    host's ranks (``LOCAL_WORLD_SIZE``);
  * :func:`spawn_processes` runs a worker script in one process per rank,
    on cards (NCCL) or, as :func:`spawn_cpu_processes`, in gloo ranks on the
    CPU, the way the tests exercise the multi-process path without cards.
"""

from __future__ import annotations

import os
import subprocess
import sys
import tempfile
import time

import torch
import torch.distributed as dist


def _init_method(address: str) -> str:
    """``host:port`` -> ``tcp://host:port``; a URL (``tcp://``, ``file://``,
    ``env://``) as it is."""
    return address if "://" in address else f"tcp://{address}"


def initialize_from_env(
    coordinator_address: str | None = None,
    num_processes: int | None = None,
    process_id: int | None = None,
    device: str | torch.device | None = None,
) -> bool:
    """Initialise the default ``torch.distributed`` process group.

    Arguments default to ``CUDDH_COORDINATOR`` (``host:port`` or an init
    URL), ``CUDDH_NUM_PROCESSES`` and ``CUDDH_PROCESS_ID``; without them,
    to ``torchrun``'s environment (``env://``).  With neither this is a
    no-op returning False.  ``device`` picks the backend: ``"cuda"`` (the
    default when a card is visible) gives NCCL and binds the process to its
    local card (``LOCAL_RANK``, else rank modulo the visible cards),
    ``"cpu"`` gives gloo.  Safe to call twice; a second call with another
    world size or rank raises.
    """
    coordinator_address = coordinator_address or os.environ.get("CUDDH_COORDINATOR")
    if num_processes is None and "CUDDH_NUM_PROCESSES" in os.environ:
        num_processes = int(os.environ["CUDDH_NUM_PROCESSES"])
    if process_id is None and "CUDDH_PROCESS_ID" in os.environ:
        process_id = int(os.environ["CUDDH_PROCESS_ID"])

    if _already_initialized():
        live = (dist.get_world_size(), dist.get_rank())
        if (num_processes is not None and live[0] != num_processes) or (
            process_id is not None and live[1] != process_id
        ):
            raise RuntimeError(
                f"torch.distributed already initialized with (world size, rank)={live}, "
                f"but initialize_from_env was asked for {(num_processes, process_id)}"
            )
        return True

    if coordinator_address is None and num_processes is None:
        if not all(k in os.environ for k in ("MASTER_ADDR", "WORLD_SIZE", "RANK")):
            return False
        coordinator_address = "env://"
        num_processes, process_id = int(os.environ["WORLD_SIZE"]), int(os.environ["RANK"])
    if coordinator_address is None or num_processes is None or process_id is None:
        raise ValueError(
            "initialize_from_env needs a coordinator address, the number of processes "
            "and this process's id (CUDDH_COORDINATOR, CUDDH_NUM_PROCESSES, CUDDH_PROCESS_ID)"
        )
    if device is None:
        device = "cuda" if torch.cuda.is_available() else "cpu"
    device = torch.device(device)
    if device.type == "cuda":
        local = int(os.environ.get("LOCAL_RANK", process_id % torch.cuda.device_count()))
        torch.cuda.set_device(local)
        backend = "nccl"
    else:
        backend = "gloo"
    dist.init_process_group(
        backend, init_method=_init_method(coordinator_address),
        world_size=num_processes, rank=process_id,
    )
    return True


def _already_initialized() -> bool:
    """Whether the default process group is live in this process."""
    return dist.is_available() and dist.is_initialized()


def mesh_device_type() -> str:
    """The ``DeviceMesh`` device type of the default group's backend."""
    return "cuda" if dist.get_backend() == "nccl" else "cpu"


def hybrid_device_mesh(
    ici_per_group: int | None = None,
    dcn_axis: str = "dcn",
    ici_axis: str = "ici",
):
    """A 2-axis ``(dcn, ici)`` ``DeviceMesh`` over every rank.

    ``ici_per_group`` ranks share a host (one dcn group each); it defaults
    to ``LOCAL_WORLD_SIZE`` (set by ``torchrun`` and
    ``spawn_cpu_processes``), else to the world size (one group).  Ranks
    are laid out row-major, so a dcn group holds consecutive ranks.
    """
    from torch.distributed.device_mesh import init_device_mesh

    if not _already_initialized():
        raise RuntimeError("hybrid_device_mesh: call initialize_from_env first")
    world = dist.get_world_size()
    if ici_per_group is None:
        ici_per_group = int(os.environ.get("LOCAL_WORLD_SIZE", world))
    if world % ici_per_group:
        raise ValueError(f"world size {world} not divisible by ici_per_group={ici_per_group}")
    return init_device_mesh(
        mesh_device_type(), (world // ici_per_group, ici_per_group),
        mesh_dim_names=(dcn_axis, ici_axis),
    )


def spawn_cpu_processes(worker_path: str, n_procs: int, devs_per_proc: int, *args,
                        timeout: float = 600.0) -> list[tuple[int, str]]:
    """Run ``worker_path`` in ``n_procs * devs_per_proc`` gloo ranks on the
    CPU: ``n_procs`` simulated hosts of ``devs_per_proc`` ranks each (no
    visible card, one intra-op thread per rank).  See ``spawn_processes``."""
    return spawn_processes(worker_path, n_procs, devs_per_proc, *args, timeout=timeout,
                           device="cpu")


def spawn_processes(worker_path: str, n_procs: int, devs_per_proc: int, *args,
                    timeout: float = 600.0, device: str = "cuda") -> list[tuple[int, str]]:
    """Run ``worker_path`` in ``n_procs * devs_per_proc`` ranks, one process
    each: on ``"cuda"`` one visible card per rank of a host (NCCL), on
    ``"cpu"`` gloo ranks with no visible card and one intra-op thread.

    Each rank has ``CUDDH_COORDINATOR`` (a ``file://`` rendezvous in a fresh
    temporary directory, so no port is needed), ``CUDDH_NUM_PROCESSES``,
    ``CUDDH_PROCESS_ID``, ``LOCAL_WORLD_SIZE`` and ``LOCAL_RANK`` set; it
    gets ``[rank, world size, devs_per_proc, *args]`` as its argv and calls
    ``initialize_from_env`` itself.  Every rank must end within ``timeout``
    seconds of the start; past it every rank still running is killed.
    Returns (return code, combined output) per rank; a killed rank has a
    negative return code.
    """
    world = n_procs * devs_per_proc
    with tempfile.TemporaryDirectory(prefix="cuddh_spawn_") as tmp:
        env = dict(os.environ)
        env.update({
            "CUDDH_COORDINATOR": "file://" + os.path.join(tmp, "rendezvous"),
            "CUDDH_NUM_PROCESSES": str(world),
            "LOCAL_WORLD_SIZE": str(devs_per_proc),
        })
        if device == "cpu":
            env.update({"CUDA_VISIBLE_DEVICES": "", "OMP_NUM_THREADS": "1"})
        procs, logs = [], []
        try:
            for rank in range(world):
                env_r = dict(env, CUDDH_PROCESS_ID=str(rank),
                             LOCAL_RANK=str(rank % devs_per_proc))
                log = open(os.path.join(tmp, f"rank{rank}.log"), "w+")
                logs.append(log)
                procs.append(subprocess.Popen(
                    [sys.executable, worker_path, str(rank), str(world), str(devs_per_proc),
                     *map(str, args)],
                    stdout=log, stderr=subprocess.STDOUT, env=env_r,
                ))
            deadline = time.monotonic() + timeout
            for p in procs:
                p.wait(timeout=max(0.0, deadline - time.monotonic()))
        except subprocess.TimeoutExpired:
            pass
        finally:
            for p in procs:
                if p.poll() is None:
                    p.kill()
                    p.wait()
        results = []
        for p, log in zip(procs, logs):
            log.seek(0)
            results.append((p.returncode, log.read()))
            log.close()
    return results
