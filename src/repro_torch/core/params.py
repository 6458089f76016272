"""Algorithm-1 constants (the batched estimator is
:func:`repro_torch.eval.fabric.controllers.tuning.optimal_params`)."""

#: practical cap on the pipelining depth Algorithm 1 may request
MAX_PIPELINING = 4096
