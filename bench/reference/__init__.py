"""The plain reference: each model family's forward pass and loss in plain
PyTorch from the configuration file's description
(``<model_type>.py``'s ``Ref``, on the shared pieces of ``model.py``),
adamw, the replica mean and S_k, and QSGD's quantized exchange with its
own copy of the threefry generator (``train.py``).  It imports nothing of
the program."""
