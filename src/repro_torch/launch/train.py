"""Training launcher: ``python -m repro_torch.launch.train --arch <id> [...]``.

Port of the JAX package's ``repro.launch.train``, with its flags, and
``--device`` (the CUDA card by default; ``--device cpu`` runs on the CPU).
It drives the fault-tolerant loop (``repro_torch.train.loop``) on one
device; checkpoints go to ``--ckpt-dir`` (default: a directory under the
system's temporary directory).
"""
import argparse
import os
import tempfile


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", required=True)
    ap.add_argument("--smoke", action="store_true", help="reduced config")
    ap.add_argument("--steps", type=int, default=100)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq-len", type=int, default=128)
    ap.add_argument("--lr", type=float, default=3e-4)
    ap.add_argument("--accum", type=int, default=1)
    ap.add_argument("--grad-sync", default="none", choices=["none", "compressed_bf16"])
    ap.add_argument("--ckpt-dir", default=os.path.join(tempfile.gettempdir(), "repro_train"))
    ap.add_argument("--ckpt-every", type=int, default=25)
    ap.add_argument("--device", default=None, help="torch device (default: the CUDA card)")
    args = ap.parse_args(argv)

    from repro_torch.configs import get_config
    from repro_torch.train.loop import TrainLoopConfig, train

    cfg = get_config(args.arch, smoke=args.smoke)
    loop = TrainLoopConfig(
        total_steps=args.steps,
        checkpoint_every=args.ckpt_every,
        checkpoint_dir=args.ckpt_dir,
        seq_len=args.seq_len,
        global_batch=args.batch,
        learning_rate=args.lr,
        accum_steps=args.accum,
        grad_sync=args.grad_sync,
    )
    stats = train(cfg, loop, device=args.device)
    print(
        f"done: steps={stats['final_step']} loss {stats['first_loss']:.3f} "
        f"-> {stats['last_loss']:.3f} recoveries={stats['recoveries']}"
    )


if __name__ == "__main__":
    main()
