"""One process of a 2-process gloo run of a sharded scene, for
``tests/test_torch_sharded.py``: the process form of the halo exchange
and of ``apply_unet_sharded`` (through ``engine.apply_unet`` under an
``ExecutionContext`` whose mesh has a ``"shard"`` axis), on the CPU."""
import torch
import torch.distributed as dist
from torch.distributed.device_mesh import init_device_mesh

from repro_torch import engine
from repro_torch.data.scenes import make_scene
from repro_torch.dist import halo_exchange
from repro_torch.models.scn import SCNUNet, UNetConfig
from repro_torch.sparse.tensor import SparseVoxelTensor


def run(rank: int, world: int, port: int, threads: int, unet_kw: dict,
        scene_kw: dict, exchange: dict, out) -> None:
    torch.set_num_threads(threads)
    dist.init_process_group("gloo", init_method=f"tcp://127.0.0.1:{port}",
                            world_size=world, rank=rank)
    try:
        mesh = init_device_mesh("cpu", (world,), mesh_dim_names=("shard",))
        group = mesh.get_group("shard")
        recv = halo_exchange(group, torch.from_numpy(exchange["feats"][rank]),
                             torch.from_numpy(exchange["send"][rank]))
        cfg = UNetConfig(**unet_kw)
        model = SCNUNet(cfg, device="cpu")
        coords, feats, _, mask = make_scene(**scene_kw)
        plan = engine.build_sharded_scene_plan(
            SparseVoxelTensor(coords, feats, mask), cfg,
            layout=engine.ShardLayout(n_shards=world), device="cpu")
        ctx = engine.ExecutionContext(mesh=mesh, device="cpu")
        with torch.no_grad():
            logits = engine.apply_unet(model, feats, plan, ctx=ctx,
                                       device="cpu")
        out.put((rank, recv.numpy(), logits.numpy(), ctx.topology_key()))
    except BaseException as e:  # the parent reads the failure, not a hang
        out.put((rank, None, None, repr(e)))
        raise
    finally:
        dist.destroy_process_group()

