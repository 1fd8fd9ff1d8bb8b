"""End-to-end CNN deployment on the port: schedule ResNet18 with LBLP,
execute the *scheduled graph* numerically (float + INT8, the INT8 nodes
through the port's kernels on the card), and show that numerics are
placement-invariant while timing follows the schedule.

    PYTHONPATH=src python examples/torch/schedule_and_run_cnn.py [--device cpu]
"""

import argparse

import torch

from repro_torch.core import CostModel, IMCESimulator, get_scheduler, make_pus
from repro_torch.kernels.conv2d import imc_conv2d
from repro_torch.kernels.imc_mvm import imc_mvm
from repro_torch.models.cnn import executor, graphs, resnet


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args()
    dev = torch.device(args.device)

    cfg = resnet.RESNET18_CIFAR
    graph = graphs.build_resnet_graph(cfg)
    params = resnet.init(torch.Generator().manual_seed(0), cfg, device=dev)
    x = torch.randn((8, 32, 32, 3),
                    generator=torch.Generator().manual_seed(1)).to(dev)

    cm = CostModel()
    fleet = make_pus(8, 4)
    assignment = get_scheduler("lblp", cm).schedule(graph, fleet)
    sim = IMCESimulator(graph, cm)
    res = sim.run(assignment, frames=96)

    print(f"{graph.name}: {len(graph)} nodes on {len(fleet)} PUs (LBLP)")
    print(f"  simulated rate    : {res.rate:.0f} fps")
    print(f"  simulated latency : {res.latency*1e3:.2f} ms")
    print(f"  mean utilization  : {res.mean_utilization*100:.1f}%")

    ref = resnet.forward(params, x, cfg)
    y_float = executor.execute(graph, params, x, mode="float")
    launches = (imc_conv2d.launches, imc_mvm.launches)
    y_int8 = executor.execute(graph, params, x, mode="int8")
    launches = (imc_conv2d.launches - launches[0],
                imc_mvm.launches - launches[1])
    torch.testing.assert_close(y_float, ref, rtol=1e-5, atol=1e-5)
    agree = (y_float.argmax(-1) == y_int8.argmax(-1)).float().mean().item()
    where = (torch.cuda.get_device_name(dev) if dev.type == "cuda"
             else "cpu (the kernels' plain versions)")
    print(f"  device                        : {where}")
    print("  float graph == reference model: exact")
    print(f"  INT8 top-1 agreement vs float : {agree*100:.0f}%")
    print(f"  INT8 kernel launches          : conv {launches[0]}, "
          f"mvm {launches[1]}")


if __name__ == "__main__":
    main()
