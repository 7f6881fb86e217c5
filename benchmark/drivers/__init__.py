"""One driver per entry of the program: ``engine`` (``DecodeEngine``,
serving) and ``train_step`` (``build_train_step``, training). A traffic
mix names its driver under ``"driver"``."""
