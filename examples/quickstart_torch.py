"""Quickstart of the PyTorch/CUDA port: the AccSS3D pipeline on one
synthetic scene, on an NVIDIA card.

pointcloud -> voxelize -> AdMAC adjacency (on the card) -> SOAR reorder ->
COIR metadata -> SPADE dataflow plan -> engine dispatch (the reference
gather + product vs the fused SSpNNA CUDA kernel, one ``sparse_conv``
entry point) -> the same conv through the pre-gathered path
(``run_sspnna_conv(fused=False)``: gather, the tile-stack CUDA kernel, an
accumulating scatter).

Run:  python examples/quickstart_torch.py             (needs a card)
      python examples/quickstart_torch.py --device cpu (plain versions)
"""
import argparse
import sys
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parents[1] / "src"))

import torch  # noqa: E402

from repro_torch import engine  # noqa: E402
from repro_torch.core import soar, spade  # noqa: E402
from repro_torch.core.hashgrid import build_neighbor_table, kernel_offsets  # noqa: E402
from repro_torch.core.sparse_conv import init_sparse_conv, submanifold_coir  # noqa: E402
from repro_torch.data.scenes import make_scene  # noqa: E402
from repro_torch.device import require_device  # noqa: E402
from repro_torch.kernels.sspnna.ops import run_sspnna_conv  # noqa: E402
from repro_torch.kernels.sspnna.sspnna import sspnna_fused, sspnna_tiles  # noqa: E402
from repro_torch.sparse.tensor import SparseVoxelTensor  # noqa: E402

RES, CAP = 48, 16384
# f32 sums of up to 27*4 products per output, taken in another order
TOL = 1e-4

parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
parser.add_argument("--device", default="cuda")
dev = require_device(parser.parse_args().device)
torch.backends.cuda.matmul.allow_tf32 = False

coords, feats, labels, mask = make_scene(0, RES, CAP)
t = SparseVoxelTensor(*(torch.from_numpy(x).to(dev)
                        for x in (coords, feats, mask)))
n_active = t.n_active()
print(f"scene: {n_active} active voxels "
      f"({n_active / RES**3:.1%} occupancy — spatial sparsity) on {dev}")

# AdMAC: adjacency + COIR metadata, built on the device
coir = submanifold_coir(t, RES, 3)
print(f"COIR: ARF = {coir.arf():.2f} active neighbours / voxel (of 27)")

# SOAR reordering (host)
nbr = build_neighbor_table(t.coords, t.mask, kernel_offsets(3), RES)
order = soar.soar_order(nbr.cpu().numpy(), mask, 512)
print(f"SOAR: {order.n_chunks} chunks")

# SPADE dataflow plan (64 KB L1 budget, like the paper)
attrs = spade.extract_attributes(coir.indices.cpu().numpy(), mask, order.order)
layer = spade.LayerSpec("demo", n_active, n_active, 27, 4, 32, 2)
plan_df = spade.explore(layer, {"CIRF": attrs, "CORF": attrs}, 64 * 1024)
print(f"SPADE: walk={plan_df.walk} flavor={plan_df.flavor} "
      f"tile dO={plan_df.delta_major} -> {plan_df.da_elems:.2e} data accesses")

# Engine: one ConvPlan, two backends through the same entry point
d_i = int(plan_df.delta_major * attrs.at(plan_df.delta_major,
                                         "sa_minor_alloc_rst")) + 27
conv_plan = engine.conv_plan_for_layer(coir, order.order,
                                       plan_df.delta_major, d_i,
                                       walk=plan_df.walk, device=dev)
params = init_sparse_conv(torch.Generator().manual_seed(0), 27, 4, 32,
                          device=dev)
launches = sspnna_fused.launches, sspnna_tiles.launches
with torch.no_grad():
    out = engine.sparse_conv(t.feats, params, conv_plan, backend="sspnna")
    ref = engine.sparse_conv(t.feats, params, conv_plan, backend="reference")
    tiles = conv_plan.tiles
    raw = run_sspnna_conv(t.feats, params.weight, tiles.out_rows,
                          tiles.in_rows, tiles.local_idx, n_out=CAP,
                          fused=False)
    gathered = (raw + params.bias) * t.mask.unsqueeze(-1)
fused_n = sspnna_fused.launches - launches[0]
tiles_n = sspnna_tiles.launches - launches[1]
m = t.mask
err = float((out[m] - ref[m]).abs().max())
err_pg = float((gathered[m] - out[m]).abs().max())
print(f"SSpNNA fused kernel over {conv_plan.dispatch.n_tiles} tiles "
      f"({fused_n} launch): max |err| vs reference = {err:.2e}")
print(f"SSpNNA pre-gathered path ({tiles_n} tile-stack launch): max |err| "
      f"vs fused = {err_pg:.2e}")
expected = 1 if dev.type == "cuda" else 0  # CPU tensors: plain versions
if (fused_n, tiles_n) != (expected, expected) or max(err, err_pg) > TOL:
    sys.exit("FAILED: wrong launch counts or results outside the tolerance")
print("OK")
