// Streaming token-block packer — the native hot loop of the data pipeline
// (the port's own copy of picotron_tpu/native/packer.cpp).
//
// The reference's dataloader concatenates tokenized documents and chunks them
// into fixed (seq_len+1)-token blocks inside a Python dataset.map callback
// (ref: picotron/data.py:57-100, `tokenizer_group_text`); its native
// performance there comes from the HF fast-tokenizer Rust core. This is the
// equivalent native component on our side: a C++ packer that accepts
// token-id buffers of arbitrary length and emits fixed-size blocks, carrying
// the remainder across calls (so no tokens are lost at feed boundaries —
// an improvement over per-map-batch tail dropping).
//
// Exposed as a plain C ABI for ctypes (no pybind11 in the image). All
// buffers are int32 token ids; the Python wrapper owns numpy conversion.
//
// Build: g++ -O3 -std=c++17 -shared -fPIC -o build/libpacker-<hash>.so
// packer.cpp, done at first use by picotron_tpu_torch/kernels/build.py
// (picotron_tpu_torch/native.py loads it; a failed build raises).

#include <cstdint>
#include <cstring>
#include <vector>

namespace {

struct Packer {
  int64_t block_size;
  // Completed blocks, stored back-to-back (ready_count * block_size ids),
  // plus the carry of the current partially-filled block.
  std::vector<int32_t> ready;
  std::vector<int32_t> carry;
};

}  // namespace

extern "C" {

void* packer_new(int64_t block_size) {
  if (block_size <= 0) return nullptr;
  auto* p = new Packer();
  p->block_size = block_size;
  p->carry.reserve(static_cast<size_t>(block_size));
  return p;
}

void packer_free(void* handle) { delete static_cast<Packer*>(handle); }

// Feed `n` token ids; completed blocks accumulate internally.
void packer_feed(void* handle, const int32_t* tokens, int64_t n) {
  auto* p = static_cast<Packer*>(handle);
  const int64_t bs = p->block_size;
  int64_t i = 0;

  // Top up the carry first.
  if (!p->carry.empty()) {
    const int64_t need = bs - static_cast<int64_t>(p->carry.size());
    const int64_t take = n < need ? n : need;
    p->carry.insert(p->carry.end(), tokens, tokens + take);
    i = take;
    if (static_cast<int64_t>(p->carry.size()) == bs) {
      p->ready.insert(p->ready.end(), p->carry.begin(), p->carry.end());
      p->carry.clear();
    }
  }

  // Bulk-copy whole blocks straight from the input.
  const int64_t whole = (n - i) / bs;
  if (whole > 0) {
    const size_t old = p->ready.size();
    p->ready.resize(old + static_cast<size_t>(whole * bs));
    std::memcpy(p->ready.data() + old, tokens + i,
                static_cast<size_t>(whole * bs) * sizeof(int32_t));
    i += whole * bs;
  }

  // Remainder becomes the new carry.
  if (i < n) p->carry.insert(p->carry.end(), tokens + i, tokens + n);
}

int64_t packer_num_ready(void* handle) {
  auto* p = static_cast<Packer*>(handle);
  return static_cast<int64_t>(p->ready.size()) / p->block_size;
}

int64_t packer_carry_len(void* handle) {
  return static_cast<int64_t>(static_cast<Packer*>(handle)->carry.size());
}

// Move up to `max_blocks` completed blocks into `out` (caller-allocated,
// max_blocks * block_size int32s). Returns the number of blocks written.
int64_t packer_take(void* handle, int32_t* out, int64_t max_blocks) {
  auto* p = static_cast<Packer*>(handle);
  const int64_t bs = p->block_size;
  const int64_t have = static_cast<int64_t>(p->ready.size()) / bs;
  const int64_t n = have < max_blocks ? have : max_blocks;
  if (n > 0) {
    std::memcpy(out, p->ready.data(),
                static_cast<size_t>(n * bs) * sizeof(int32_t));
    p->ready.erase(p->ready.begin(), p->ready.begin() + n * bs);
  }
  return n;
}

}  // extern "C"
