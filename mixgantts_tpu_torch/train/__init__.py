from .guards import check_finite_metrics, debug_nans
from .state import TrainState, create_train_state
from .step import make_eval_step, make_train_step
