"""The native FFmpeg video decoder (``video_decoder.cpp``) and its build."""
