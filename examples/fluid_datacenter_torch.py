"""FLuID at datacenter scale on the PyTorch port: masked sub-model training
on a transformer (twin of examples/fluid_datacenter.py).

A straggler *pod* trains a masked sub-model whose FFN units were invariant
across the fast pods. The masks are data: one train step serves every
mask. Uses a reduced stablelm config.

Run:  PYTHONPATH=src python examples/fluid_datacenter_torch.py [--device cpu]
"""
import argparse

from repro_torch.configs import get_config
from repro_torch.launch.train import run_fluid


def run(device="cuda", steps=12, batch=2, seq=32, rate=0.75, calibrate_every=4):
    """The reference's run_fluid; returns (full time, FLuID time, the
    per-step log of (loss, t_full, t_fluid)) in modelled time units."""
    cfg = get_config("stablelm-12b").smoke().with_overrides(grad_accum=1)
    params, log = run_fluid(cfg, steps=steps, batch=batch, seq=seq, rate=rate,
                            calibrate_every=calibrate_every, device=device)
    full_t = sum(t for _, t, _ in log)
    fluid_t = sum(t for _, _, t in log)
    print(f"\nmodeled straggler-pod time: full={full_t:.1f}u "
          f"fluid={fluid_t:.1f}u ({full_t / fluid_t:.2f}x faster once masked)")
    return full_t, fluid_t, log


def main(argv=None):
    ap = argparse.ArgumentParser(description="Datacenter FLuID on the PyTorch port")
    ap.add_argument("--device", default="cuda",
                    help="cuda (the default) or cpu")
    return run(device=ap.parse_args(argv).device)


if __name__ == "__main__":
    main()
