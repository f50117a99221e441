"""``python -m show_and_tell_tpu_torch``: point users at the entry points."""

import sys

BANNER = """\
show_and_tell_tpu_torch: Show-Attend-Tell image captioning in PyTorch, with hand-written CUDA kernels for Hopper

Entry points (each accepts --help; each runs on the GPU):
  python -m show_and_tell_tpu_torch.cli.preprocess        build vocab + data.json from Karpathy JSON
  python -m show_and_tell_tpu_torch.cli.pack_memmap       pack resized images into memmap shards
  python -m show_and_tell_tpu_torch.cli.import_vocab      import a reference vocabulary pickle
  python -m show_and_tell_tpu_torch.cli.main              train (CIDEr-gated checkpoints, preempt and resume)
  python -m show_and_tell_tpu_torch.cli.train_chain       train as a chain of one-epoch child processes
  python -m show_and_tell_tpu_torch.cli.evaluate          val loss + beam decode + full metric suite
  python -m show_and_tell_tpu_torch.cli.score             score a results file against COCO annotations
  python -m show_and_tell_tpu_torch.cli.extract_features  precompute encoder features (.npz)
  python -m show_and_tell_tpu_torch.cli.caption           caption image files/directories
  python -m show_and_tell_tpu_torch.cli.serve_http        HTTP caption server with dynamic batching
  python -m show_and_tell_tpu_torch.cli.export_torch      export a reference-format model-best.pth

Check on the card: python3 chip_smoke.py
Docs: README.md, PERF.md, ROADMAP.md
"""


def main() -> int:
    try:
        print(BANNER)
    except BrokenPipeError:  # `| head` closed the pipe
        pass
    return 0


if __name__ == "__main__":
    sys.exit(main())
