"""Offline tools of the port: the GMM penalty fit (``penalty_em``), the
synthetic FlyingChairs writer (``synth_dataset``) and the training
comparisons (``sanity_train``, ``bf16_compare``, ``real_frame_train``,
``taylor_compare``)."""
