from nbody_tpu_torch.vis.server import main

main()
