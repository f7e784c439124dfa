from tpugan_torch.export.exporter import (  # noqa: F401
    ExportedGenerator,
    export_generator,
    load_generator,
    save_generator,
)
