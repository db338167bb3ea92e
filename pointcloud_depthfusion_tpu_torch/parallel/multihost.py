"""Multi-process scale-out: camera rigs spanning processes or hosts. Port
of pointcloud_depthfusion_tpu/parallel/multihost.py on ``torch.distributed``.

The reference spans two machines over DDS/UDP (README.md:14-34: one Jetson
per camera, fusion subscribing over the network). The port keeps the same
sharded step as parallel/mesh.py (cameras sharded over a mesh, one MIN
merge), but the mesh spans processes: ``torch.distributed`` joins them,
each process holds its own cameras' frames on its own shards
(:func:`shard_local_cameras`), and the merge's ``all_reduce(MIN)`` runs
over NCCL between cards or gloo between CPU processes.

The backend follows the arguments alone, never the hardware found:
``local_virtual_devices`` > 0 is the CPU simulation (that many CPU shards a
process, gloo); otherwise each process drives its card with NCCL (one
shard, ``cuda:<rank mod device count>``), and no card raises. NCCL refuses
two ranks on one card, so on a one-card machine the card runs one process
(``--local-devices 0``); the multi-process run is the gloo simulation:
``python -m pointcloud_depthfusion_tpu_torch.parallel.multihost
--num-processes 2 --process-id k`` launches one worker.
"""

from __future__ import annotations

import argparse
import json
import os
from typing import Optional

import numpy as np
import torch

#: This process's shard devices, set by :func:`initialize_multihost`.
_local_devices: tuple = ()


def initialize_multihost(
    coordinator_address: Optional[str] = None,
    num_processes: Optional[int] = None,
    process_id: Optional[int] = None,
    local_virtual_devices: Optional[int] = None,
) -> None:
    """Join the process group of a process-spanning mesh.

    ``coordinator_address`` ("host:port", process 0 listens there),
    ``num_processes`` and ``process_id`` go to
    ``torch.distributed.init_process_group``; with no coordinator it reads
    the ``MASTER_ADDR``/``MASTER_PORT``/``WORLD_SIZE``/``RANK`` environment.
    ``local_virtual_devices`` > 0: that many CPU shards a process over gloo;
    otherwise one card a process over NCCL (raises without a card).
    """
    global _local_devices
    import torch.distributed as dist  # noqa: PLC0415

    if local_virtual_devices:
        backend = "gloo"
        devices = (torch.device("cpu"),) * int(local_virtual_devices)
    else:
        if not torch.cuda.is_available():
            raise RuntimeError("the nccl backend needs a CUDA device; pass "
                               "local_virtual_devices > 0 for the CPU simulation (gloo)")
        backend = "nccl"
        rank = int(os.environ.get("RANK", 0)) if process_id is None else process_id
        devices = (torch.device("cuda", rank % torch.cuda.device_count()),)
        torch.cuda.set_device(devices[0])
    kwargs = {}
    if coordinator_address is not None:
        kwargs = dict(init_method=f"tcp://{coordinator_address}", world_size=num_processes,
                      rank=process_id)
    if backend == "nccl":
        kwargs["device_id"] = devices[0]
    dist.init_process_group(backend, **kwargs)
    _local_devices = devices


def global_camera_mesh(axis: str = "cam"):
    """The 1-D camera mesh over every shard of every process."""
    import torch.distributed as dist  # noqa: PLC0415

    from pointcloud_depthfusion_tpu_torch.parallel.mesh import CameraMesh  # noqa: PLC0415

    if not dist.is_initialized():
        raise RuntimeError("global_camera_mesh: call initialize_multihost first")
    return CameraMesh(_local_devices, axis, dist.group.WORLD)


def shard_local_cameras(mesh, axis: str, *host_arrays: np.ndarray):
    """Each array's LOCAL cameras (its leading axis: this process's shards'
    cameras) split over this process's shards, each on its device: the
    inputs of ``rig_fuse_sharded`` over the whole axis, in place of the
    reference's network hop of full framesets."""
    from pointcloud_depthfusion_tpu_torch.parallel.mesh import shard_cameras  # noqa: PLC0415

    return tuple(shard_cameras(mesh, torch.from_numpy(np.ascontiguousarray(a)), axis)
                 for a in host_arrays)


def rig_poses(first: int, count: int, n_cams: int) -> list:
    """Camera→world poses of cameras ``first .. first + count - 1`` of an
    ``n_cams``-camera arc (yaw -15° to 15°, x -0.4 to 0.4 m)."""
    poses = []
    for i in range(first, first + count):
        yaw = np.deg2rad(-15 + 30 * i / max(n_cams - 1, 1))
        rot = np.array([[np.cos(yaw), 0, np.sin(yaw)], [0, 1, 0],
                        [-np.sin(yaw), 0, np.cos(yaw)]])
        m = np.eye(4)
        m[:3, :3] = rot
        m[:3, 3] = [0.8 * (i / max(n_cams - 1, 1) - 0.5), 0, 0]
        poses.append(m.astype(np.float32))
    return poses


def _worker(args) -> dict:
    initialize_multihost(args.coordinator, args.num_processes, args.process_id,
                         local_virtual_devices=args.local_devices)
    import torch.distributed as dist  # noqa: PLC0415

    from pointcloud_depthfusion_tpu_torch.core.camera import Intrinsics  # noqa: PLC0415
    from pointcloud_depthfusion_tpu_torch.fusion.pipeline import FusionConfig  # noqa: PLC0415
    from pointcloud_depthfusion_tpu_torch.io.synthetic import SyntheticScene  # noqa: PLC0415
    from pointcloud_depthfusion_tpu_torch.parallel.mesh import rig_fuse_sharded  # noqa: PLC0415

    try:
        mesh = global_camera_mesh()
        n_cams = mesh.size
        local = len(mesh.devices)
        first = mesh.first_shard
        device = mesh.devices[0]
        w, h = args.width, args.height
        host = Intrinsics.create(w, h, fx=50.0 * w / 64, fy=50.0 * w / 64, ppx=w / 2,
                                 ppy=h / 2, device="cpu")
        poses = rig_poses(first, local, n_cams)
        frames = [SyntheticScene().render(host, m) for m in poses]
        config = FusionConfig.create(vertical_image=False, mirror_image=False,
                                     filter_fused_color=False, device=device)
        intr = host.to(device)
        depth, color, scale, pose = shard_local_cameras(
            mesh, "cam",
            np.stack([f.depth for f in frames]).astype(np.int32),
            np.stack([f.color for f in frames]),
            np.full((local,), 0.001, np.float32), np.stack(poses),
        )
        fn = rig_fuse_sharded(mesh, intr, intr, config)
        img = fn(depth, color, scale, pose).cpu().numpy()
        coverage = float((img.sum(-1) > 0).mean())
        print(f"multihost worker {args.process_id}/{args.num_processes}: fused "
              f"{img.shape} coverage {coverage:.2f} backend {dist.get_backend()}", flush=True)
        if args.out and args.process_id == 0:
            np.save(args.out, img)
        return {"process_id": args.process_id, "shape": list(img.shape), "coverage": coverage,
                "backend": dist.get_backend(), "cameras": n_cams}
    finally:
        dist.destroy_process_group()


def main(argv=None) -> None:
    parser = argparse.ArgumentParser(
        description="multi-host rig-fusion worker (one process per host)"
    )
    parser.add_argument("--coordinator", default="localhost:12355")
    parser.add_argument("--num-processes", type=int, required=True)
    parser.add_argument("--process-id", type=int, required=True)
    parser.add_argument("--local-devices", type=int, default=2,
                        help="CPU shards per process (simulation, gloo); "
                        "0 = this process's card (nccl)")
    parser.add_argument("--width", type=int, default=64)
    parser.add_argument("--height", type=int, default=48)
    parser.add_argument("--out", default="",
                        help="process 0 writes the fused image here (.npy)")
    args = parser.parse_args(argv)
    print(json.dumps(_worker(args)), flush=True)


if __name__ == "__main__":
    main()
