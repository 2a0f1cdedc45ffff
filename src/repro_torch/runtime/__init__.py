from repro_torch.runtime.trainer import StragglerDetector, Trainer

__all__ = ["StragglerDetector", "Trainer"]
