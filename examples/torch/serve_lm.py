"""Serve a small LM with batched requests through the port's
continuous-batching server (prefill through the flash kernel on the card,
lockstep decode, failure-recovery path included).

    PYTHONPATH=src python examples/torch/serve_lm.py [--device cpu]
"""

import argparse
import time

import torch

from repro_torch.configs import get_config
from repro_torch.kernels.flash_attention import flash_attention
from repro_torch.models.lm import transformer
from repro_torch.runtime.serve_loop import Request, Server


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args()
    dev = torch.device(args.device)

    cfg = get_config("gemma3-1b").smoke()
    params = transformer.init_params(cfg, torch.Generator().manual_seed(0),
                                     device=dev)
    server = Server(cfg, params, max_batch=4, s_max=96)

    rng = torch.Generator().manual_seed(1)
    requests = []
    for i in range(10):
        plen = int(torch.randint(4, 24, (), generator=rng))
        prompt = torch.randint(0, cfg.vocab, (plen,), generator=rng,
                               dtype=torch.int32)
        requests.append(Request(rid=i, prompt=prompt, max_new=8))

    launches = flash_attention.launches
    t0 = time.perf_counter()
    stats = server.serve(requests)
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
    dt = time.perf_counter() - t0
    total_new = sum(len(r.out_tokens) for r in requests)
    where = torch.cuda.get_device_name(dev) if dev.type == "cuda" else "cpu"
    print(f"served {stats.served} requests, {total_new} new tokens, "
          f"{stats.prefills} prefills, {stats.decode_steps} decode steps "
          f"in {dt:.1f}s ({total_new/dt:.1f} tok/s on {where}); flash "
          f"kernel launches {flash_attention.launches - launches}")
    for r in requests[:3]:
        print(f"  req {r.rid}: prompt[{r.prompt.shape[0]}] -> {r.out_tokens}")


if __name__ == "__main__":
    main()
