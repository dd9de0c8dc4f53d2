"""Device ms a training step in the loss's convolutions (cuDNN's and
PyTorch's convolution kernels, by name)."""

#: Name parts of the convolution kernels cuDNN and PyTorch launch.
CONV_NAMES = ("conv", "Conv", "cudnn", "xmma", "implicit_gemm", "fprop", "dgrad", "wgrad",
              "winograd", "fft")


def read(run):
    return run["trace"].kernel_ms_per_unit(lambda name: any(k in name for k in CONV_NAMES))
