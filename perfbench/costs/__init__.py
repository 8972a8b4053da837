"""The yardstick's arithmetic: the card's peaks, the work each kernel call
must do, and the model FLOPs of a configuration.  Frozen here, so that no
change to the program can move what its numbers are measured against."""
