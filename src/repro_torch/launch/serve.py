"""Serving launcher: ``python -m repro_torch.launch.serve --arch <id> [...]``.

Runs on the CUDA card unless ``--device cpu`` is given.
"""
import argparse


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", required=True)
    ap.add_argument("--smoke", action="store_true")
    ap.add_argument("--requests", type=int, default=8)
    ap.add_argument("--prompt-len", type=int, default=16)
    ap.add_argument("--max-new", type=int, default=16)
    ap.add_argument("--temperature", type=float, default=0.0)
    ap.add_argument("--device", default=None, help="torch device (default: the CUDA card)")
    args = ap.parse_args(argv)

    import numpy as np

    from repro_torch.configs import get_config
    from repro_torch.models import Model
    from repro_torch.serving.llm_demo import Request, ServeEngine

    cfg = get_config(args.arch, smoke=args.smoke)
    params = Model(cfg, device=args.device).init(0)
    eng = ServeEngine(cfg, params, max_batch=8)
    rng = np.random.default_rng(0)
    for i in range(args.requests):
        eng.submit(
            Request(
                request_id=i,
                prompt=rng.integers(0, cfg.vocab_size, args.prompt_len).tolist(),
                max_new_tokens=args.max_new,
                temperature=args.temperature,
            )
        )
    results = eng.run()
    for rid in sorted(results):
        print(f"request {rid}: {results[rid]}")


if __name__ == "__main__":
    main()
