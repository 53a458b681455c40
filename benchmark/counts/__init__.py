"""The yardstick's arithmetic: the H100's peaks, the model FLOPs of a pair
or an image, and each attention call's operations and bytes."""
