from veomni_tpu_torch.train.train_step import TrainState, build_train_state, build_train_step

__all__ = ["TrainState", "build_train_step", "build_train_state"]
