// vectorindex_tpu binary container: native (C++) persistence tier.
//
// The PyTorch port's own copy of vectorindex_tpu/persistence/native/
// container.cpp, with the same file format (magic INDEXTPU, 256 B header,
// 64 B TOC entries, WAL records, CRC32): a file written by either package
// opens in the other. Built with g++ -O2 -std=c++20 -fPIC -shared at first
// use by vectorindex_tpu_torch/persistence/container.py into
// build/container/<hash of source and flags>/ under the repository root.
//
// Differences from the reference copy:
//   - vc_open bounds-checks the header and every TOC entry against the file
//     size (offset + capacity, nbytes <= capacity, the WAL section too), and
//     WAL replay checks every record it applies against the mapping. A
//     truncated or corrupt file returns -2 (CORRUPT_DATA) and is never read
//     past its mapping (the reference's vc_verify_section reads
//     offset + nbytes unchecked).
//   - vc_crc32 runs slicing-by-8 tables: the same CRC-32 (polynomial
//     0xEDB88320, init and final xor 0xFFFFFFFF) at several times the speed
//     of the byte-at-a-time loop, so checksums written by either package
//     verify in the other.
//
// Parity target (reference S1): Sources/VectorIndex/Kernels/VIndexMmap.swift
// (binary mmap container: 256B header with magic/version/endianness/
// generation/CRC32 VIndexMmap.swift:70-143, typed-section TOC :73-77,
// growth-with-copy appends :633-712, WAL append/commit records with CRC tags
// :600-604, wal replay on open :830, msync :359-362, release/acquire
// publication of section lengths for lock-free readers per CAtomicsShim.h)
// and VIndexContainerBuilder.swift.
//
// Layout:
//   [Header 256B][TOC cap_sections*64B][section data ... 64B aligned][WAL]
// Growth: a section that outgrows its capacity is relocated to EOF with 2x
// capacity (TOC offset updated, old space dead until rebuild) — the
// relocation analog of the reference's grow-with-copy-and-remap.
// Durability: vc_append_begin writes a WAL BEGIN record (fdatasync), data is
// written, vc_append_commit writes a COMMIT record with data CRC, then the
// new length publishes to the TOC with a release store; vc_wal_replay on
// open rolls lengths forward for committed appends whose TOC publication
// was lost.

#include <atomic>
#include <cstdint>
#include <cstring>
#include <cstdio>
#include <cstdlib>
#include <fcntl.h>
#include <sys/mman.h>
#include <sys/stat.h>
#include <unistd.h>

extern "C" {

// ---------------------------------------------------------------------------
// constants / structs
// ---------------------------------------------------------------------------

static const uint64_t VC_MAGIC = 0x5550545845444E49ULL; // "INDEXTPU" LE
static const uint32_t VC_VERSION = 1;
static const uint32_t VC_ENDIAN_TAG = 0x01020304u;
static const uint32_t VC_ALIGN = 64;

// section types (superset of the reference's section enum VIndexMmap.swift:73-77)
enum VCSectionType : uint32_t {
  VC_SEC_CENTROIDS = 1,
  VC_SEC_CODEBOOKS = 2,
  VC_SEC_CENTROID_NORMS = 3,
  VC_SEC_LISTS_DESC = 4,
  VC_SEC_IDS = 5,
  VC_SEC_CODES = 6,
  VC_SEC_VECS = 7,
  VC_SEC_NORMS_INV = 8,
  VC_SEC_NORMS_SQ = 9,
  VC_SEC_IDMAP = 10,
  VC_SEC_TOMBSTONES = 11,
  VC_SEC_TELEMETRY = 12,
  VC_SEC_FREELIST = 13,
  VC_SEC_WAL = 14,
  VC_SEC_META = 15,
};

#pragma pack(push, 1)
struct VCHeader {
  uint64_t magic;
  uint32_t version;
  uint32_t endian_tag;
  uint64_t generation;
  uint32_t n_sections;
  uint32_t cap_sections;
  uint64_t file_size;
  uint32_t header_crc; // crc of header with this field zeroed
  uint8_t reserved[256 - 8 - 4 - 4 - 8 - 4 - 4 - 8 - 4];
};

struct VCSection {
  uint32_t type;
  uint32_t dtype;     // caller-defined tag (numpy dtype enum on py side)
  uint64_t offset;    // absolute file offset
  uint64_t nbytes;    // live bytes (published with release semantics)
  uint64_t capacity;  // reserved bytes
  uint64_t nrows;
  uint64_t row_stride;
  uint32_t crc32;     // data crc at last full sync (0 = not computed)
  uint8_t reserved[64 - 4 - 4 - 8 - 8 - 8 - 8 - 8 - 4];
};

struct VCWalRecord { // reference WAL records VIndexMmap.swift:600-604
  uint32_t magic;    // 'W','A','L',kind
  uint32_t section_index;
  uint64_t offset;   // data offset within section
  uint64_t nbytes;
  uint32_t data_crc;
  uint32_t rec_crc;  // crc of record with this field zeroed
};
#pragma pack(pop)

static const uint32_t VC_WAL_BEGIN = 0x4257414CU;  // "LAWB"
static const uint32_t VC_WAL_COMMIT = 0x4357414CU; // "LAWC"
static const uint32_t VC_WAL_RELOC = 0x5257414CU;  // "LAWR" — grow-with-copy
// relocation: offset field = new section offset, nbytes = new capacity.
// Written durably BEFORE the TOC offset update so replay can find data that
// moved between the last TOC sync and a crash.

struct VCHandle {
  int fd;
  uint8_t* map;
  uint64_t map_size;
  int writable;
  uint64_t wal_cursor; // write offset within the WAL section
  // Read-only replay side table: WAL replay on a PROT_READ mapping must not
  // write through the mapping (SIGSEGV); rolled-forward section state lives
  // in this heap copy of the TOC instead, consulted by all section readers.
  VCSection* ro_toc;
};

// ---------------------------------------------------------------------------
// crc32 (standard polynomial, table-driven)
// ---------------------------------------------------------------------------

static uint32_t g_crc_table[8][256];
static bool g_crc_init = false;

static void crc_init() {
  if (g_crc_init) return;
  for (uint32_t i = 0; i < 256; i++) {
    uint32_t c = i;
    for (int k = 0; k < 8; k++)
      c = (c & 1) ? 0xEDB88320u ^ (c >> 1) : c >> 1;
    g_crc_table[0][i] = c;
  }
  // table t advances a byte's contribution by t more zero bytes
  for (uint32_t i = 0; i < 256; i++)
    for (int t = 1; t < 8; t++)
      g_crc_table[t][i] = (g_crc_table[t - 1][i] >> 8) ^
                          g_crc_table[0][g_crc_table[t - 1][i] & 0xFF];
  g_crc_init = true;
}

uint32_t vc_crc32(const void* data, uint64_t n) {
  crc_init();
  uint32_t c = 0xFFFFFFFFu;
  const uint8_t* p = (const uint8_t*)data;
  // slicing-by-8 over little-endian 8-byte words (VC_ENDIAN_TAG: the
  // format is little-endian only)
  while (n >= 8) {
    uint32_t lo, hi;
    memcpy(&lo, p, 4);
    memcpy(&hi, p + 4, 4);
    lo ^= c;
    c = g_crc_table[7][lo & 0xFF] ^ g_crc_table[6][(lo >> 8) & 0xFF] ^
        g_crc_table[5][(lo >> 16) & 0xFF] ^ g_crc_table[4][lo >> 24] ^
        g_crc_table[3][hi & 0xFF] ^ g_crc_table[2][(hi >> 8) & 0xFF] ^
        g_crc_table[1][(hi >> 16) & 0xFF] ^ g_crc_table[0][hi >> 24];
    p += 8;
    n -= 8;
  }
  while (n--) c = g_crc_table[0][(c ^ *p++) & 0xFF] ^ (c >> 8);
  return c ^ 0xFFFFFFFFu;
}

// ---------------------------------------------------------------------------
// helpers
// ---------------------------------------------------------------------------

static uint64_t align_up(uint64_t x, uint64_t a) { return (x + a - 1) / a * a; }

static VCHeader* header_of(VCHandle* h) { return (VCHeader*)h->map; }
static VCSection* toc_of(VCHandle* h) { return (VCSection*)(h->map + sizeof(VCHeader)); }

// Section view for readers: the replay side table when present (read-only
// handles whose WAL replay rolled state forward), else the mapped TOC.
static VCSection* section_view(VCHandle* h, uint32_t idx) {
  return h->ro_toc ? &h->ro_toc[idx] : &toc_of(h)[idx];
}

// Mutable section for WAL replay: the mapped TOC when writable, else a
// lazily-allocated heap copy of the whole TOC.
static VCSection* replay_section(VCHandle* h, uint32_t idx) {
  if (h->writable) return &toc_of(h)[idx];
  if (!h->ro_toc) {
    uint32_t n = header_of(h)->n_sections;
    h->ro_toc = (VCSection*)malloc((size_t)n * sizeof(VCSection));
    memcpy(h->ro_toc, toc_of(h), (size_t)n * sizeof(VCSection));
  }
  return &h->ro_toc[idx];
}

// msync the page range covering the header + TOC (durable length/offset
// publication — see vc_append_commit / grow-with-copy).
static int sync_toc(VCHandle* h) {
  uint64_t end = sizeof(VCHeader) +
                 (uint64_t)header_of(h)->cap_sections * sizeof(VCSection);
  return msync(h->map, align_up(end, 4096), MS_SYNC);
}

static void update_header_crc(VCHandle* h) {
  VCHeader* hd = header_of(h);
  hd->header_crc = 0;
  hd->header_crc = vc_crc32(hd, sizeof(VCHeader));
}

// Section CRCs cover "data at last full sync" (VCSection.crc32 comment):
// appends/WAL writes grow nbytes past the recorded CRC range, so every
// durable point (vc_sync / writable vc_close) recomputes them — otherwise
// a container fails vc_verify_section forever after its first append.
static void update_section_crcs(VCHandle* h) {
  VCHeader* hd = header_of(h);
  VCSection* toc = toc_of(h);
  for (uint32_t i = 0; i < hd->n_sections; i++) {
    VCSection* s = &toc[i];
    s->crc32 = s->nbytes ? vc_crc32(h->map + s->offset, s->nbytes) : 0;
  }
}

static int remap(VCHandle* h, uint64_t new_size) {
  if (ftruncate(h->fd, (off_t)new_size) != 0) return -1;
  void* m = mremap(h->map, h->map_size, new_size, MREMAP_MAYMOVE);
  if (m == MAP_FAILED) return -1;
  h->map = (uint8_t*)m;
  h->map_size = new_size;
  header_of(h)->file_size = new_size;
  return 0;
}

// ---------------------------------------------------------------------------
// lifecycle
// ---------------------------------------------------------------------------

void* vc_create(const char* path, uint32_t cap_sections, uint64_t wal_capacity) {
  crc_init();
  int fd = open(path, O_RDWR | O_CREAT | O_TRUNC, 0644);
  if (fd < 0) return nullptr;
  uint64_t toc_bytes = (uint64_t)cap_sections * sizeof(VCSection);
  uint64_t wal_off = align_up(sizeof(VCHeader) + toc_bytes, VC_ALIGN);
  uint64_t size = align_up(wal_off + wal_capacity, VC_ALIGN);
  if (ftruncate(fd, (off_t)size) != 0) { close(fd); return nullptr; }
  void* m = mmap(nullptr, size, PROT_READ | PROT_WRITE, MAP_SHARED, fd, 0);
  if (m == MAP_FAILED) { close(fd); return nullptr; }
  VCHandle* h = new VCHandle{fd, (uint8_t*)m, size, 1, 0, nullptr};
  VCHeader* hd = header_of(h);
  memset(hd, 0, sizeof(VCHeader));
  hd->magic = VC_MAGIC;
  hd->version = VC_VERSION;
  hd->endian_tag = VC_ENDIAN_TAG;
  hd->generation = 1;
  hd->n_sections = 1; // section 0 = WAL
  hd->cap_sections = cap_sections;
  hd->file_size = size;
  VCSection* wal = &toc_of(h)[0];
  memset(wal, 0, sizeof(VCSection));
  wal->type = VC_SEC_WAL;
  wal->offset = wal_off;
  wal->capacity = wal_capacity;
  update_header_crc(h);
  return h;
}

// error codes: 0 ok, -1 io, -2 bad magic, -3 version, -4 endianness, -5 crc
int vc_validate(void* vh) {
  VCHandle* h = (VCHandle*)vh;
  VCHeader* hd = header_of(h);
  if (hd->magic != VC_MAGIC) return -2;
  if (hd->version != VC_VERSION) return -3;
  if (hd->endian_tag != VC_ENDIAN_TAG) return -4;
  VCHeader tmp;
  memcpy(&tmp, hd, sizeof(tmp));
  uint32_t got = tmp.header_crc;
  tmp.header_crc = 0;
  if (vc_crc32(&tmp, sizeof(tmp)) != got) return -5;
  return 0;
}

// a byte range [offset, offset + len) lies inside the mapping (no overflow)
static bool in_map(VCHandle* h, uint64_t offset, uint64_t len) {
  return offset <= h->map_size && len <= h->map_size - offset;
}

// Every TOC entry against the file: the TOC itself, each section's
// [offset, offset + capacity) after the TOC and inside the file, and
// nbytes <= capacity. A truncated file fails here (-2), before any reader
// can follow an entry past the mapping.
int vc_check_bounds(void* vh) {
  VCHandle* h = (VCHandle*)vh;
  VCHeader* hd = header_of(h);
  if (hd->n_sections == 0 || hd->n_sections > hd->cap_sections) return -2;
  uint64_t toc_end = sizeof(VCHeader) + (uint64_t)hd->cap_sections * sizeof(VCSection);
  if (hd->cap_sections > (h->map_size - sizeof(VCHeader)) / sizeof(VCSection)) return -2;
  if (hd->file_size > h->map_size) return -2; // truncated after the last write
  VCSection* toc = toc_of(h);
  if (toc[0].type != VC_SEC_WAL) return -2;
  for (uint32_t i = 0; i < hd->n_sections; i++) {
    VCSection* s = &toc[i];
    if (s->offset < toc_end || !in_map(h, s->offset, s->capacity) ||
        s->nbytes > s->capacity)
      return -2;
  }
  return 0;
}

void* vc_open(const char* path, int writable, int* err) {
  crc_init();
  if (err) *err = 0;
  int fd = open(path, writable ? O_RDWR : O_RDONLY);
  if (fd < 0) { if (err) *err = -1; return nullptr; }
  struct stat st;
  if (fstat(fd, &st) != 0) { close(fd); if (err) *err = -1; return nullptr; }
  if ((uint64_t)st.st_size < sizeof(VCHeader)) { // shorter than a header
    close(fd); if (err) *err = -2; return nullptr;
  }
  void* m = mmap(nullptr, (size_t)st.st_size,
                 writable ? PROT_READ | PROT_WRITE : PROT_READ,
                 MAP_SHARED, fd, 0);
  if (m == MAP_FAILED) { close(fd); if (err) *err = -1; return nullptr; }
  VCHandle* h = new VCHandle{fd, (uint8_t*)m, (uint64_t)st.st_size, writable, 0, nullptr};
  int v = vc_validate(h);
  if (v == 0) v = vc_check_bounds(h);
  if (v != 0) {
    munmap(m, (size_t)st.st_size); close(fd); delete h;
    if (err) *err = v;
    return nullptr;
  }
  return h;
}

void vc_close(void* vh) {
  VCHandle* h = (VCHandle*)vh;
  if (!h) return;
  if (h->writable) {
    update_section_crcs(h);
    update_header_crc(h);
    msync(h->map, h->map_size, MS_SYNC);
  }
  munmap(h->map, h->map_size);
  close(h->fd);
  free(h->ro_toc);
  delete h;
}

int vc_sync(void* vh) { // reference msync full map :359-362
  VCHandle* h = (VCHandle*)vh;
  if (!h->writable) return -1;
  update_section_crcs(h);
  update_header_crc(h);
  return msync(h->map, h->map_size, MS_SYNC);
}

uint64_t vc_generation(void* vh) { return header_of((VCHandle*)vh)->generation; }
void vc_bump_generation(void* vh) {
  VCHandle* h = (VCHandle*)vh;
  if (!h->writable) return;
  header_of(h)->generation++;
  update_header_crc(h);
}
uint32_t vc_section_count(void* vh) { return header_of((VCHandle*)vh)->n_sections; }

// ---------------------------------------------------------------------------
// sections
// ---------------------------------------------------------------------------

int vc_add_section(void* vh, uint32_t type, uint32_t dtype,
                   const void* data, uint64_t nbytes, uint64_t capacity,
                   uint64_t nrows, uint64_t row_stride) {
  VCHandle* h = (VCHandle*)vh;
  VCHeader* hd = header_of(h);
  if (!h->writable || hd->n_sections >= hd->cap_sections) return -1;
  if (capacity < nbytes) capacity = nbytes;
  capacity = align_up(capacity ? capacity : VC_ALIGN, VC_ALIGN);
  uint64_t off = align_up(h->map_size, VC_ALIGN);
  if (remap(h, off + capacity) != 0) return -1;
  hd = header_of(h); // mremap may move the mapping — refetch all pointers
  VCSection* s = &toc_of(h)[hd->n_sections];
  memset(s, 0, sizeof(VCSection));
  s->type = type;
  s->dtype = dtype;
  s->offset = off;
  s->nbytes = nbytes;
  s->capacity = capacity;
  s->nrows = nrows;
  s->row_stride = row_stride;
  if (data && nbytes) memcpy(h->map + off, data, nbytes);
  s->crc32 = nbytes ? vc_crc32(h->map + off, nbytes) : 0;
  int idx = (int)hd->n_sections;
  hd->n_sections++;
  update_header_crc(h);
  return idx;
}

int vc_find_section(void* vh, uint32_t type, uint32_t nth) {
  VCHandle* h = (VCHandle*)vh;
  VCHeader* hd = header_of(h);
  uint32_t seen = 0;
  for (uint32_t i = 0; i < hd->n_sections; i++) {
    if (section_view(h, i)->type == type) {
      if (seen == nth) return (int)i;
      seen++;
    }
  }
  return -1;
}

// out params: ptr (mapped, zero-copy), nbytes, capacity, dtype, nrows, stride
int vc_section_info(void* vh, int idx, void** ptr, uint64_t* nbytes,
                    uint64_t* capacity, uint32_t* dtype, uint64_t* nrows,
                    uint64_t* row_stride, uint32_t* type) {
  VCHandle* h = (VCHandle*)vh;
  VCHeader* hd = header_of(h);
  if (idx < 0 || (uint32_t)idx >= hd->n_sections) return -1;
  VCSection* s = section_view(h, (uint32_t)idx);
  if (ptr) *ptr = h->map + s->offset;
  // acquire load pairs with the release publication in vc_append_commit
  if (nbytes) *nbytes = std::atomic_ref<uint64_t>(s->nbytes).load(std::memory_order_acquire);
  if (capacity) *capacity = s->capacity;
  if (dtype) *dtype = s->dtype;
  if (nrows) *nrows = s->nrows;
  if (row_stride) *row_stride = s->row_stride;
  if (type) *type = s->type;
  return 0;
}

int vc_verify_section(void* vh, int idx) { // 0 ok, -1 no section, -5 crc mismatch
  VCHandle* h = (VCHandle*)vh;
  if (idx < 0 || (uint32_t)idx >= header_of(h)->n_sections) return -1;
  VCSection* s = section_view(h, (uint32_t)idx);
  if (!s->crc32) return 0;
  uint32_t got = vc_crc32(h->map + s->offset, s->nbytes);
  return got == s->crc32 ? 0 : -5;
}

int vc_set_nrows(void* vh, int idx, uint64_t nrows) {
  VCHandle* h = (VCHandle*)vh;
  if (!h->writable) return -1;
  toc_of(h)[idx].nrows = nrows;
  update_header_crc(h);
  return 0;
}

// ---------------------------------------------------------------------------
// durable append (WAL) — reference mmap_append_begin/commit/replay
// ---------------------------------------------------------------------------

static VCSection* wal_section(VCHandle* h) { return &toc_of(h)[0]; }

static int wal_write(VCHandle* h, VCWalRecord* rec) {
  VCSection* w = wal_section(h);
  if (h->wal_cursor + sizeof(VCWalRecord) > w->capacity) return -1; // wal full
  rec->rec_crc = 0;
  rec->rec_crc = vc_crc32(rec, sizeof(*rec));
  memcpy(h->map + w->offset + h->wal_cursor, rec, sizeof(*rec));
  msync(h->map + (w->offset + h->wal_cursor) / 4096 * 4096,
        sizeof(*rec) + 4096, MS_SYNC);
  h->wal_cursor += sizeof(VCWalRecord);
  std::atomic_ref<uint64_t>(w->nbytes).store(h->wal_cursor, std::memory_order_release);
  return 0;
}

// Reserve `nbytes` at the end of section idx; grows (relocates) if needed.
// Returns the in-section offset of the reservation, or UINT64_MAX on error.
uint64_t vc_append_begin(void* vh, int idx, uint64_t nbytes) {
  VCHandle* h = (VCHandle*)vh;
  if (!h->writable || idx <= 0 || (uint32_t)idx >= header_of(h)->n_sections)
    return UINT64_MAX;
  VCSection* s = &toc_of(h)[idx];
  uint64_t cur = s->nbytes;
  if (cur + nbytes > s->capacity) {
    // grow-with-copy: relocate to EOF with doubled capacity (reference
    // :633-712 grows the mapping and copies the list region).
    // Crash-durability order: (1) copy + msync the data at its new home,
    // (2) durably log a RELOC record, (3) update the TOC offset and sync it.
    // Replay applies RELOC records, so committed data stays reachable even
    // if the crash lands between any of these steps.
    uint64_t new_cap = s->capacity ? s->capacity : VC_ALIGN;
    while (cur + nbytes > new_cap) new_cap *= 2;
    uint64_t new_off = align_up(h->map_size, VC_ALIGN);
    if (remap(h, new_off + new_cap) != 0) return UINT64_MAX;
    s = &toc_of(h)[idx]; // remap may have moved the mapping
    memcpy(h->map + new_off, h->map + s->offset, cur);
    if (cur)
      msync(h->map + new_off / 4096 * 4096, (new_off % 4096) + cur, MS_SYNC);
    VCWalRecord reloc{VC_WAL_RELOC, (uint32_t)idx, new_off, new_cap, 0, 0};
    if (wal_write(h, &reloc) != 0) return UINT64_MAX;
    s->offset = new_off;
    s->capacity = new_cap;
    update_header_crc(h);
    sync_toc(h);
  }
  VCWalRecord rec{VC_WAL_BEGIN, (uint32_t)idx, cur, nbytes, 0, 0};
  if (wal_write(h, &rec) != 0) return UINT64_MAX;
  return cur;
}

// Write data into the reservation and durably publish the new length.
int vc_append_commit(void* vh, int idx, uint64_t offset, const void* data,
                     uint64_t nbytes) {
  VCHandle* h = (VCHandle*)vh;
  VCSection* s = &toc_of(h)[idx];
  memcpy(h->map + s->offset + offset, data, nbytes);
  uint32_t dcrc = vc_crc32(data, nbytes);
  msync(h->map + s->offset / 4096 * 4096,
        (s->offset % 4096) + offset + nbytes, MS_SYNC);
  VCWalRecord rec{VC_WAL_COMMIT, (uint32_t)idx, offset, nbytes, dcrc, 0};
  if (wal_write(h, &rec) != 0) return -1;
  // publish the new live length (release — readers use acquire), then make
  // the publication power-crash durable by syncing the header/TOC page.
  // (Replay would also roll it forward from the COMMIT record; the sync
  // makes the common path not depend on replay.)
  std::atomic_ref<uint64_t>(s->nbytes).store(offset + nbytes, std::memory_order_release);
  update_header_crc(h);
  sync_toc(h);
  return 0;
}

// Roll forward committed appends (and section relocations) whose TOC
// publication was lost — crash between commit record and header sync.
// Scans the WAL area record-by-record until the first CRC-invalid record
// (the torn tail / zeroed remainder) rather than trusting the TOC's WAL
// length, which is itself only crash-durable via this same mechanism.
// Read-only handles roll forward into a heap TOC copy (never write through
// a PROT_READ mapping). Returns records applied, or -5 if a committed
// record's data fails its CRC (real corruption).
int vc_wal_replay(void* vh) {
  VCHandle* h = (VCHandle*)vh;
  VCSection* w = wal_section(h);
  uint64_t max_rec = w->capacity / sizeof(VCWalRecord);
  int applied = 0;
  uint64_t i = 0;
  for (; i < max_rec; i++) {
    VCWalRecord rec;
    memcpy(&rec, h->map + w->offset + i * sizeof(rec), sizeof(rec));
    VCWalRecord tmp = rec;
    uint32_t got = tmp.rec_crc;
    tmp.rec_crc = 0;
    if (vc_crc32(&tmp, sizeof(tmp)) != got) break; // torn/zeroed tail — stop
    if (rec.section_index == 0 || rec.section_index >= header_of(h)->n_sections)
      break; // WAL itself / out of range — malformed, stop
    if (rec.magic == VC_WAL_RELOC) {
      if (!in_map(h, rec.offset, rec.nbytes)) return -2; // moved past the file's end
      VCSection* s = section_view(h, rec.section_index);
      if (s->offset != rec.offset) {
        s = replay_section(h, rec.section_index);
        s->offset = rec.offset;
        s->capacity = rec.nbytes;
        applied++;
      }
      continue;
    }
    if (rec.magic != VC_WAL_COMMIT) {
      if (rec.magic != VC_WAL_BEGIN) break; // unknown kind — stop
      continue;
    }
    VCSection* s = section_view(h, rec.section_index);
    uint64_t cur = s->nbytes;
    uint64_t want = rec.offset + rec.nbytes;
    if (want > cur) {
      if (rec.offset > want || want > s->capacity) return -2; // past the section
      uint32_t dcrc = vc_crc32(h->map + s->offset + rec.offset, rec.nbytes);
      if (dcrc != rec.data_crc) return -5;
      s = replay_section(h, rec.section_index);
      if (h->writable)
        std::atomic_ref<uint64_t>(s->nbytes).store(want, std::memory_order_release);
      else
        s->nbytes = want;
      // refresh the rolled-forward section's data CRC in the effective TOC
      // view — the recorded crc32 covers the pre-append length, so verify
      // would falsely flag a correctly-recovered section
      s->crc32 = vc_crc32(h->map + s->offset, want);
      applied++;
    }
  }
  h->wal_cursor = i * sizeof(VCWalRecord);
  if (h->writable) {
    std::atomic_ref<uint64_t>(w->nbytes).store(h->wal_cursor, std::memory_order_release);
    if (applied) update_header_crc(h);
  }
  return applied;
}

int vc_wal_reset(void* vh) { // checkpoint: truncate the log
  VCHandle* h = (VCHandle*)vh;
  if (!h->writable) return -1;
  VCSection* w = wal_section(h);
  // Zero the log area so scan-based replay can never resurrect records from
  // before this checkpoint (stale records still CRC-validate otherwise).
  memset(h->map + w->offset, 0, w->capacity);
  h->wal_cursor = 0;
  std::atomic_ref<uint64_t>(w->nbytes).store(0, std::memory_order_release);
  update_header_crc(h);
  return msync(h->map, h->map_size, MS_SYNC);
}

} // extern "C"
