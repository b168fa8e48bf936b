"""The upload worker's host time a chunk fanning it out over the mesh:
issuing every shard's copies up (the program's `mesh.h2d` spans) and
every stream shard's compiled step (`mesh.dispatch`), summed a chunk,
mean ms over the chunks uploaded in the window (routes/lc_mesh.py's
counters over the program's recorder)."""


def read(run):
    ns, chunks = run.counted("mesh.fanout_ns"), run.counted("mesh.chunks_up")
    if not ns or not chunks:
        return None
    return ns / chunks / 1e6
