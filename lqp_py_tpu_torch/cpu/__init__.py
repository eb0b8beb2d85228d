"""Framework-free CPU oracles of the port: the numpy scalar ADMM
(``boxqp_numpy``) and the ctypes binding of the native C++ solver
(``native``)."""
