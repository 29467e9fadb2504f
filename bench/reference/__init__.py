"""The plain reference: OLMo-1B and DeepSeek-V2 (MLA, the router, the
capacity dispatch and the experts) in plain PyTorch from the configuration
file's description, adamw, the replica mean and S_k, and QSGD's quantized
exchange with its own copy of the threefry generator.  It imports nothing
of the program."""
