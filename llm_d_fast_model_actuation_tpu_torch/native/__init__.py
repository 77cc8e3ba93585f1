"""The port's bindings to the machine's own libraries (NVML), over ctypes."""
