from mdgat_tpu_torch.train.loop import (TrainState, create_train_state,
                                        make_eval_step, make_train_step)

__all__ = ["TrainState", "create_train_state", "make_eval_step",
           "make_train_step"]
