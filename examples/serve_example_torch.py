"""Personalized sub-model serving on the PyTorch port: one decode program,
many clients (twin of examples/serve_example.py).

Queues requests carrying three different sub-model sizes (1.0 = full model,
0.5, 0.25) with ragged prompt/generation lengths through the
continuous-batching ServeEngine. Every request's keep-mask is data: a row
of the engine's mask bank, gathered per slot, so mixing rates changes no
shape and no op. In torch there is no trace to count; the "one program for
every rate" property the reference prints as trace counts is the
mask-as-data contract, which ``repro_torch.analysis`` checks
(``analysis/contracts.py::check_serve_mask_as_data``). This example prints
the serving kernels' launches instead: on the card every decode layer runs
the masked-FFN kernel and every GQA attention layer the flash-decode kernel
(all zero on the CPU, which runs their plain versions). Works for every
decoder-only architecture (recurrent archs need full-window prompts):

  PYTHONPATH=src python examples/serve_example_torch.py stablelm-12b [--device cpu]
"""
import argparse

import numpy as np
import torch

from repro_torch.configs import get_config
from repro_torch.kernels import ops
from repro_torch.launch.serving import ServeEngine, ServeRequest, rate_masks
from repro_torch.models import model as model_lib


def run(arch="stablelm-12b", device="cuda", batch_size=2, max_prompt_len=12,
        max_gen_len=12):
    """The reference's queue; returns ({rid: tokens}, engine summary)."""
    if torch.device(device).type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(f"device={device!r} needs a CUDA device and none is "
                           f"available; pass --device cpu")
    cfg = get_config(arch).smoke()
    params = model_lib.init_params(cfg, 0, device)

    eng = ServeEngine(cfg, params, batch_size=batch_size,
                      max_prompt_len=max_prompt_len, max_gen_len=max_gen_len,
                      device=device)
    ops.reset_launch_counts()              # this run's launches only
    rng = np.random.RandomState(0)
    for i, r in enumerate([1.0, 0.5, 0.25, 0.5, 1.0]):
        L = eng.max_prompt_len if eng.recurrent else int(rng.randint(6, 13))
        prompt = rng.randint(0, min(cfg.vocab_size, 256), (L,), dtype=np.int32)
        masks = None if r >= 1.0 else rate_masks(cfg, r, seed=0)
        rid = eng.submit(ServeRequest(prompt, gen_len=int(rng.randint(6, 13)),
                                      masks=masks))
        print(f"request {rid}: sub-model r={r}, prompt {L} tokens")

    results = eng.run()
    for rid in sorted(results):
        print(f"request {rid} -> {results[rid].tolist()}")
    s = eng.summary()
    print(f"{arch}: {s['tok_per_s']:.0f} tok/s decode, "
          f"kernel_launches={s['kernel_launches']} (the mask is data: one "
          f"program serves every rate)")
    return results, s


def main(argv=None):
    ap = argparse.ArgumentParser(description="Sub-model serving on the PyTorch port")
    ap.add_argument("arch", nargs="?", default="stablelm-12b")
    ap.add_argument("--device", default="cuda",
                    help="cuda (the default) or cpu")
    args = ap.parse_args(argv)
    return run(arch=args.arch, device=args.device)


if __name__ == "__main__":
    main()
