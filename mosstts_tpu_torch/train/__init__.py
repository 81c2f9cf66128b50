"""Training: ``TTSTrainer`` and ``synthetic_tts_batch`` (``trainer.py``),
``save_train_state`` and ``restore_train_state`` (``checkpoint.py``), the
optimizers (``optim.py``) and the data loader (``data.py``). The names
import on first use, so ``python -m mosstts_tpu_torch.train.trainer`` runs
its module once."""

_EXPORTS = {"TTSTrainer": "trainer", "synthetic_tts_batch": "trainer",
            "save_train_state": "checkpoint", "restore_train_state": "checkpoint"}


def __getattr__(name):
    if name not in _EXPORTS:
        raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
    import importlib

    return getattr(importlib.import_module(f".{_EXPORTS[name]}", __name__), name)
