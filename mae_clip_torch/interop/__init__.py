"""Weight interop: the JAX package's params -> the port's state_dict."""
