from repro_torch.ft.trainer import (FailureInjected, FaultTolerantTrainer,
                                    StragglerDetector, TrainerConfig)

__all__ = ["FailureInjected", "FaultTolerantTrainer", "StragglerDetector",
           "TrainerConfig"]
