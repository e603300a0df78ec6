from graphmine_tpu_torch.pipeline.driver import main

main()
