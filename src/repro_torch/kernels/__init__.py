# Hand-written CUDA kernels for Hopper, one subpackage per kernel of the
# JAX package (src/repro/kernels), each with
#   ops.py — the public wrapper: checks its inputs, allocates the outputs,
#            launches the kernel on a CUDA tensor and keeps a launch count;
#            a CPU tensor goes to the plain version instead
#   ref.py — the plain PyTorch version of the same function
# The CUDA sources live in csrc/ and are built at first use (_build.py).
