"""End-to-end driver of the PyTorch port: SFT warmup then CoPRIS GRPO
training on the synthetic math task, with metrics and checkpoints. A thin
wrapper over the port's launcher: the same CLI scales from `tiny` to any
assigned arch (``--smoke`` for the reduced configs). Runs on the card
unless ``--device cpu`` is given.

    PYTHONPATH=src python examples/torch_train_grpo_copris.py        # tiny, 60 steps
    PYTHONPATH=src python examples/torch_train_grpo_copris.py --device cpu
    # one-step-async pipeline: rollout overlaps the optimizer step, the
    # cross-stage IS correction absorbs the one-update staleness
    PYTHONPATH=src python examples/torch_train_grpo_copris.py --overlap
    # multi-step pipeline (producer runs up to 2 updates ahead) with the
    # versioned ParamStore weight sync and overlap-aware adaptive N'
    PYTHONPATH=src python examples/torch_train_grpo_copris.py --overlap \\
        --max-staleness 2 --disaggregated --adaptive-concurrency
"""
import sys

from repro_torch.launch.train import main

if __name__ == "__main__":
    argv = sys.argv[1:] or []
    defaults = ["--arch", "tiny", "--mode", "copris", "--steps", "60",
                "--sft-warmup", "150", "--out", "runs/quick_copris_torch"]
    # user args win over defaults
    main(defaults + argv)
