"""Train a reduced llama-family model with the PyTorch port's full loop:
queue-ordered deterministic data pipeline, AdamW, checkpointing every 25
steps, and an injected node failure that the run recovers from
(restart from the checkpoint, identical trajectory).

Run:  PYTHONPATH=src python examples/torch_train_lm.py [--steps 200]
[--device cpu] (default device ``cuda``; it raises where there is none).
"""
import argparse
import tempfile

from repro_torch.launch.train import train_loop


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--steps", type=int, default=200)
    ap.add_argument("--arch", default="llama3_8b")
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)

    with tempfile.TemporaryDirectory() as ckpt:
        state, losses, metrics = train_loop(
            args.arch, reduced=True, steps=args.steps, global_batch=8,
            seq_len=64, ckpt_dir=ckpt, ckpt_every=25,
            fail_at=(min(60, args.steps // 2),), device=args.device)
    first, last = losses[0][1], losses[-1][1]
    print(f"\ntrained {args.steps} steps with 1 injected failure on "
          f"{args.device}: loss {first:.3f} -> {last:.3f}; {metrics}")
    assert last < first, "loss must decrease"


if __name__ == "__main__":
    main()
