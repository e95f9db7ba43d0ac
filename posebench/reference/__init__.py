"""The plain reference of the OpenPose COCO model and its decode.

Written from the published architecture and the configuration files; it
imports neither the program (``tpupose_torch``) nor the JAX package, and
takes nothing the program has made. ``model`` is the network in plain
``torch`` operations, ``decode`` the multi-person decode on the
scale-averaged maps, ``skeleton`` the COCO-18 tables.
"""
