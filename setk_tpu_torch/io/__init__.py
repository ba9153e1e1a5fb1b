from setk_tpu_torch.io.wave import read_wav, write_wav
from setk_tpu_torch.io.readers import (Reader, ScpReader, DirReader, WaveReader,
                                 SegmentWaveReader, SpectrogramReader,
                                 NumpyReader, PickleReader, MatReader,
                                 BinaryReader, ScriptReader, ArchiveReader,
                                 ExrawReader, ExrawScriptReader, MaskReader,
                                 parse_scps)
from setk_tpu_torch.io.writers import (Writer, ArchiveWriter, WaveWriter,
                                 NumpyWriter, MatWriter, ExrawWriter)

__all__ = [
    "read_wav", "write_wav", "Reader", "ScpReader", "DirReader", "WaveReader",
    "SegmentWaveReader", "SpectrogramReader", "NumpyReader", "PickleReader",
    "MatReader", "BinaryReader", "ScriptReader", "ArchiveReader",
    "ExrawReader", "ExrawScriptReader", "MaskReader", "parse_scps", "Writer",
    "ArchiveWriter", "WaveWriter", "NumpyWriter", "MatWriter", "ExrawWriter"
]
