"""The benchmark's own arithmetic: the FLOPs a model step must do and the
bytes a kernel must move, from the configuration's sizes alone."""
